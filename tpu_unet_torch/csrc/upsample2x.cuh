// The x2 align-corners bilinear upsample of NHWC bf16 tensors, eight
// channels at a time: the lerp that csrc/decoder_fuse.cu's upsample kernel
// (launch key upsample2x) writes `up` with, for the Hopper conv core and
// weight-gradient GEMM to read by TMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tu {
namespace {

// Eight channels [c, c + 8) at output pixel (uy, ux) of the x2
// align-corners bilinear upsample of x (B, H2/2, W2/2, Cx), image b, from
// its four neighbours.  Rounding follows the plain version: the H pass
// rounds to bf16, then the W pass; products and sums are kept unfused
// (__fmul_rn/__fadd_rn) so the result is bit-equal to it.  Row/column
// tables: idx (2, n) int32, w (2, n) f32.
__device__ __forceinline__ uint4 up2x_lerp8(const __nv_bfloat16* x, const int* ridx,
                                            const float* rw, const int* cidx, const float* cw,
                                            int H2, int W2, int Cx, int b, int uy, int ux,
                                            int c) {
  using bf16 = __nv_bfloat16;
  const int Hx = H2 / 2, Wx = W2 / 2;
  const int r0 = ridx[uy], r1 = ridx[H2 + uy];
  const float wr0 = rw[uy], wr1 = rw[H2 + uy];
  const int q0 = cidx[ux], q1 = cidx[W2 + ux];
  const float wc0 = cw[ux], wc1 = cw[W2 + ux];
  const bf16* base = x + static_cast<size_t>(b) * Hx * Wx * Cx + c;
  auto at = [&](int r, int q) {
    return *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(r) * Wx + q) * Cx);
  };
  const uint4 u00 = at(r0, q0), u10 = at(r1, q0), u01 = at(r0, q1), u11 = at(r1, q1);
  const bf16* v00 = reinterpret_cast<const bf16*>(&u00);
  const bf16* v10 = reinterpret_cast<const bf16*>(&u10);
  const bf16* v01 = reinterpret_cast<const bf16*>(&u01);
  const bf16* v11 = reinterpret_cast<const bf16*>(&u11);
  __align__(16) bf16 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float h0 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
        __fmul_rn(__bfloat162float(v00[j]), wr0), __fmul_rn(__bfloat162float(v10[j]), wr1))));
    const float h1 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
        __fmul_rn(__bfloat162float(v01[j]), wr0), __fmul_rn(__bfloat162float(v11[j]), wr1))));
    o[j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(h0, wc0), __fmul_rn(h1, wc1)));
  }
  return *reinterpret_cast<const uint4*>(o);
}

}  // namespace
}  // namespace tu
