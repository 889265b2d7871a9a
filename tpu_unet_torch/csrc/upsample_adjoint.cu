// upsample_adjoint: the adjoint of the x2 align-corners bilinear upsample of
// NHWC bf16 tensors, dx (B, H, W, C) from dup (B, 2H, 2W, C), for one
// UnetUp decoder stage's backward.
//
// Replaces the dx epilogue of tpu_unet/kernels/decoder_train.py's stage
// backwards (:327-338) and the overlap-add of their per-tile dx windows,
// _overlap_add_windows (the Pallas call at :1208).  The kernel, its design
// and its bound are in csrc/upsample_adjoint.cuh, which csrc/upconv.cu
// shares for the up_conv head's dx.
#include "upsample_adjoint.cuh"

using tu::bf16;

extern "C" int tu_upsample_adjoint(const bf16* dup, const int* ridx, const float* rw, int nr,
                                   const int* cidx, const float* cw, int nc, bf16* dx, int B,
                                   int H, int W, int C, cudaStream_t stream) {
  return tu::launch_upsample_adjoint(dup, ridx, rw, nr, cidx, cw, nc, dx, B, H, W, C, stream);
}
