// unetup_wgrad: the weight and bias gradients of one UnetUp decoder stage,
// in float32 —
//   dk1[f, c, ky, kx] = sum_p dz1[p, f] * cc[p + (ky - 1, kx - 1), c],
//                       cc = [skip | up2x(x)]  (SAME padding: 0 outside)
//   dk2[f, c, ky, kx] = sum_p g2[p, f] * y1[p + (ky - 1, kx - 1), c]
//   db1[f] = sum_p dz1[p, f],  db2[f] = sum_p g2[p, f]
// over the B * 2H * 2W pixels p, with dz1 and g2 from the dgrad chain
// (csrc/decoder_train.cu).
//
// Replaces the in-kernel weight gradients of
// tpu_unet/kernels/decoder_train.py's stage backwards (#14 / #16 and their
// low-res schedules #15 / #17, _bwd_kernel_v2 :340-374) and #18's repack of
// their paired accumulators (_repack_wgrad, the Pallas call at :1146): in
// natural layout the GEMM writes the (F, Cin, 3, 3) gradient directly.
//
// Each weight gradient is one launch of the shared GEMM over the pixels
// (csrc/wgrad.cuh), its im2col operand gathered by the forward's own
// loaders (csrc/conv3x3.cuh): NhwcLoader over y1 for dk2, UpConcatLoader for
// dk1, so the skip | up concat is never stored and its up half goes through
// the forward's lerp and bf16 rounding (H pass, then W pass).  The split-K
// is sized on the host to fill the 132 SMs (up1's dk1 has only 27 tiles);
// the partials are added in split order, so the result is bit-identical
// run to run.
//
// Bound on the H100: operations (2 * 9 * P * F * (Cs + Cx + F): 0.63 ms for
// up1 at 512x512, batch 8, at 989 TFLOP/s bf16).  The design is the same
// single-stage mma.sync core as the forward, at a similar share of the peak.
// Shapes: 2H % 8, 2W % 16, F % 64, (Cs + Cx) % 64, Cs % 8 all 0.
#include "wgrad.cuh"

using tu::bf16;

// work1 holds ns1 * F * (9 * (Cs + Cx) + 1) floats, work2 ns2 * F * (9 * F + 1).
extern "C" int tu_unetup_wgrad(const bf16* skip, const bf16* x, const int* ridx, const float* rw,
                               const int* cidx, const float* cw, const bf16* dz1, const bf16* y1,
                               const bf16* g2, float* work1, float* work2, float* dk1, float* db1,
                               float* dk2, float* db2, int B, int H2, int W2, int Cs, int Cx,
                               int F, int ns1, int ns2, cudaStream_t stream) {
  const tu::UpConcatLoader up{skip, x, ridx, rw, cidx, cw, H2, W2, Cs, Cx};
  cudaError_t e = tu::launch_wgrad(up, dz1, work1, dk1, db1, B, H2, W2, Cs + Cx, F, ns1, stream);
  if (e != cudaSuccess) return e;
  return tu::launch_wgrad(tu::NhwcLoader{y1, H2, W2, F}, g2, work2, dk2, db2, B, H2, W2, F, F,
                          ns2, stream);
}
