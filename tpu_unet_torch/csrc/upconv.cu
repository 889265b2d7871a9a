// upconv: the up_conv head of unet_resnet50 and self_net, forward —
//   relu(conv2(relu(conv1(up2x_align_corners(x)))))
// with both convs 3x3 SAME and no skip.
//
// Replaces tpu_unet/kernels/upconv.py::fused_upconv_impl (the Pallas call at
// upconv.py:227) and its other TPU schedule _fused_upconv_call_p2
// (upconv.py:288), which compute the same function.  As on the TPU, the x2
// upsampled tensor never reaches device memory: conv1's operand loader is
// the decoder's UpConcatLoader with no skip channels (Cs = 0), which lerps
// each up element from x's four neighbours with host-made row/column tables
// and rounds as the plain version does (H pass to bf16, then W pass).
// conv1's output y1 goes through device memory to a second launch of the
// conv core (conv2, NhwcLoader).
//
// Bound on the H100: compute (309 GFLOP at the unet_resnet50 head,
// 8x256x256x64 -> 8x512x512x64; 0.31 ms at 989 TFLOP/s).  conv1 has K = 576
// only, and each of its A elements costs four 16-byte loads and two lerps
// for each of the 9 taps, so conv1 is bound by its loader, not by the
// tensor cores; lerping once per low-res element into shared memory would
// remove that and is left to a later change.
#include "conv3x3.cuh"

using tu::bf16;

extern "C" int tu_upconv(const bf16* x, const int* ridx, const float* rw, const int* cidx,
                         const float* cw, const bf16* w1, const float* b1, const bf16* w2,
                         const float* b2, bf16* y1, bf16* out, int B, int H2, int W2, int Cx,
                         int F, cudaStream_t stream) {
  const tu::UpConcatLoader ld1{nullptr, x, ridx, rw, cidx, cw, H2, W2, 0, Cx};
  cudaError_t e = tu::launch_conv3x3<tu::UpConcatLoader, false>(
      ld1, w1, b1, y1, nullptr, B, H2, W2, 9 * Cx, F, stream);
  if (e != cudaSuccess) return e;
  return tu::launch_conv3x3<tu::NhwcLoader, false>(tu::NhwcLoader{y1, H2, W2, F}, w2, b2, out,
                                                   nullptr, B, H2, W2, 9 * F, F, stream);
}
