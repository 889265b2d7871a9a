// The adjoint of the x2 align-corners bilinear upsample of
// NHWC bf16 tensors, dx (B, H, W, C) from dup (B, 2H, 2W, C):
//   dx[b, i, j, c] = sum_{(u, wr) in R(i)} wr * sum_{(v, wc) in C(j)} wc * dup[b, u, v, c]
// where R(i) / C(j) list the high-resolution rows / columns whose lerp reads
// low-resolution row i / column j, with the forward's bf16-rounded weights
// (host tables from nn/resize.py::adjoint_tables: (n, nr) int32 indices,
// -1 past the end of a list, and float32 weights).
//
// Replaces the dx epilogue of tpu_unet/kernels/decoder_train.py's stage
// backwards: the W- and H-lerp adjoints inside fused_unetup_bwd_paired_impl
// / fused_unetup_bwd_wide_impl (:327-338) and the overlap-add of their
// per-tile dx windows, _overlap_add_windows (the Pallas call at :1208).
// In natural layout there are no windows: each thread gathers.
//
// Gather form: one thread owns one low-resolution pixel and 8 channels
// (16-byte loads and store) and sums its at most nr x nc contributions in
// float32 in a fixed order (W pass inside, H pass outside), then rounds once
// to bf16.  No atomics, so the result is bit-identical run to run.
// Bound on the H100: bytes (dup read once, dx written once: 0.20 ms for
// up1 at 512x512, batch 8, C 128, at 3.35 TB/s); each dup element is read
// by about 4 threads, which L1 / L2 serve.  Shapes: C % 8 == 0.
//
// Shared by csrc/upsample_adjoint.cu (a decoder stage's dx) and
// csrc/upconv.cu (the up_conv head's dx).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tu {
namespace {

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(256)
upsample_adjoint_kernel(const bf16* __restrict__ dup, const int* __restrict__ ridx,
                        const float* __restrict__ rw, int nr, const int* __restrict__ cidx,
                        const float* __restrict__ cw, int nc, bf16* __restrict__ dx, int B, int H,
                        int W, int C) {
  const int C8 = C / 8;
  const size_t total = static_cast<size_t>(B) * H * W * C8;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c8 = static_cast<int>(t % C8);
  size_t r = t / C8;
  const int j = static_cast<int>(r % W);
  r /= W;
  const int i = static_cast<int>(r % H);
  const int b = static_cast<int>(r / H);
  const int W2 = 2 * W;
  const bf16* base = dup + static_cast<size_t>(b) * (2 * H) * W2 * C + c8 * 8;

  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int a = 0; a < nr; ++a) {
    const int u = ridx[i * nr + a];
    if (u < 0) break;
    const float wr = rw[i * nr + a];
    float row[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) row[k] = 0.f;
    for (int q = 0; q < nc; ++q) {
      const int v = cidx[j * nc + q];
      if (v < 0) break;
      const float wc = cw[j * nc + q];
      const uint4 d = *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(u) * W2 + v) * C);
      const bf16* dv = reinterpret_cast<const bf16*>(&d);
#pragma unroll
      for (int k = 0; k < 8; ++k) row[k] = fmaf(wc, __bfloat162float(dv[k]), row[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = fmaf(wr, row[k], acc[k]);
  }
  __align__(16) bf16 o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(acc[k]);
  *reinterpret_cast<uint4*>(dx + t * 8) = *reinterpret_cast<const uint4*>(o);
}

// Launch on `stream`; returns cudaGetLastError().
inline cudaError_t launch_upsample_adjoint(const bf16* dup, const int* ridx, const float* rw,
                                           int nr, const int* cidx, const float* cw, int nc,
                                           bf16* dx, int B, int H, int W, int C,
                                           cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * H * W * (C / 8);
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  upsample_adjoint_kernel<<<blocks, 256, 0, stream>>>(dup, ridx, rw, nr, cidx, cw, nc, dx, B, H,
                                                      W, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tu

