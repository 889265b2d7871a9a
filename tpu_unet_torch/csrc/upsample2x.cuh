// The x2 align-corners bilinear upsample of NHWC bf16 or float32 tensors, 16
// bytes of channels at a time: the lerp that csrc/decoder_fuse.cu's
// upsample kernel (launch key upsample2x) writes `up` with, for the Hopper
// conv core and weight-gradient GEMM to read by TMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tu {
namespace {

// The 16 bytes of channels [c, c + 16 / sizeof(T)) at output pixel (uy, ux)
// of the x2 align-corners bilinear upsample of x (B, H2/2, W2/2, Cx), image
// b, from its four neighbours.  Rounding follows the plain version: in bf16
// the H pass rounds to bf16, then the W pass; in float32 neither pass
// rounds but as float32 arithmetic does.  Products and sums are kept
// unfused (__fmul_rn / __fadd_rn) so the result is bit-equal to it.
// Row/column tables: idx (2, n) int32, w (2, n) f32 (the weights rounded to
// T).
template <typename T>
__device__ __forceinline__ uint4 up2x_lerp(const T* x, const int* ridx, const float* rw,
                                           const int* cidx, const float* cw, int H2, int W2,
                                           int Cx, int b, int uy, int ux, int c) {
  constexpr int EL = 16 / static_cast<int>(sizeof(T));
  const int Hx = H2 / 2, Wx = W2 / 2;
  const int r0 = ridx[uy], r1 = ridx[H2 + uy];
  const float wr0 = rw[uy], wr1 = rw[H2 + uy];
  const int q0 = cidx[ux], q1 = cidx[W2 + ux];
  const float wc0 = cw[ux], wc1 = cw[W2 + ux];
  const T* base = x + static_cast<size_t>(b) * Hx * Wx * Cx + c;
  auto at = [&](int r, int q) {
    return *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(r) * Wx + q) * Cx);
  };
  const uint4 u00 = at(r0, q0), u10 = at(r1, q0), u01 = at(r0, q1), u11 = at(r1, q1);
  const T* v00 = reinterpret_cast<const T*>(&u00);
  const T* v10 = reinterpret_cast<const T*>(&u10);
  const T* v01 = reinterpret_cast<const T*>(&u01);
  const T* v11 = reinterpret_cast<const T*>(&u11);
  __align__(16) T o[EL];
#pragma unroll
  for (int j = 0; j < EL; ++j) {
    if constexpr (sizeof(T) == 4) {
      const float h0 = __fadd_rn(__fmul_rn(v00[j], wr0), __fmul_rn(v10[j], wr1));
      const float h1 = __fadd_rn(__fmul_rn(v01[j], wr0), __fmul_rn(v11[j], wr1));
      o[j] = __fadd_rn(__fmul_rn(h0, wc0), __fmul_rn(h1, wc1));
    } else {
      const float h0 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__bfloat162float(v00[j]), wr0), __fmul_rn(__bfloat162float(v10[j]), wr1))));
      const float h1 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__bfloat162float(v01[j]), wr0), __fmul_rn(__bfloat162float(v11[j]), wr1))));
      o[j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(h0, wc0), __fmul_rn(h1, wc1)));
    }
  }
  return *reinterpret_cast<const uint4*>(o);
}

}  // namespace
}  // namespace tu
