// upsample_adjoint: the adjoint of the x2 align-corners bilinear upsample of
// NHWC bf16 or float32 tensors, dx (B, H, W, C) from dup (B, 2H, 2W, C),
// for one UnetUp decoder stage's backward.
//
// Replaces the dx epilogue of tpu_unet/kernels/decoder_train.py's stage
// backwards (:327-338) and the overlap-add of their per-tile dx windows,
// _overlap_add_windows (the Pallas call at :1208).  The kernel, its design
// and its bound are in csrc/upsample_adjoint.cuh, which csrc/upconv.cu
// shares for the up_conv head's dx.
#include "upsample_adjoint.cuh"

using tu::bf16;

// dup, dx bf16, or float32 with f32
extern "C" int tu_upsample_adjoint(const void* dup, const int* ridx, const float* rw, int nr,
                                   const int* cidx, const float* cw, int nc, void* dx, int B,
                                   int H, int W, int C, int f32, cudaStream_t stream) {
  if (f32)
    return tu::launch_upsample_adjoint<float>(static_cast<const float*>(dup), ridx, rw, nr, cidx,
                                              cw, nc, static_cast<float*>(dx), B, H, W, C, stream);
  return tu::launch_upsample_adjoint<bf16>(static_cast<const bf16*>(dup), ridx, rw, nr, cidx, cw,
                                           nc, static_cast<bf16*>(dx), B, H, W, C, stream);
}

// The launch plan the kernel takes at (B, H, W, C) in bf16 (or float32 with
// f32), for the host's mirror (kernels/decoder_train.py::adjoint_plan) to
// be checked against: out = [tw, cc, th, strips, chunks, bands, consumers,
// stage_bytes, smem, grid].
extern "C" int tu_upsample_adjoint_plan(int B, int H, int W, int C, int f32, long long* out) {
  if (B < 1 || H < 1 || W < 1 || C < 8 || C % 8) return cudaErrorInvalidValue;
  const tu::adj::Plan p = tu::adj::plan(B, H, W, C, f32 ? 4 : 2);
  const long long words[10] = {p.tw,     p.cc,        p.th,   p.strips, p.chunks,
                               p.bands,  p.consumers, p.stage_bytes, p.smem, p.grid};
  for (int k = 0; k < 10; ++k) out[k] = words[k];
  return 0;
}
