// upconv: the up_conv head of unet_resnet50 and self_net, forward and
// backward.  Forward (tu_upconv) —
//   relu(conv2(relu(conv1(up2x_align_corners(x)))))
// with both convs 3x3 SAME and no skip.
//
// Replaces tpu_unet/kernels/upconv.py::fused_upconv_impl (the Pallas call at
// upconv.py:227) and its other TPU schedule _fused_upconv_call_p2
// (upconv.py:288), which compute the same function.  On the TPU the x2
// upsampled tensor never reaches HBM.  Here the head is a UnetUp stage
// (csrc/decoder_fuse.cu) with no skip channels, three launches:
//   1. tu_upsample2x (csrc/decoder_fuse.cu, called by the wrapper) writes
//      up = up2x(x) (B, 2H, 2W, Cx) in bf16, once, bit-equal to the plain
//      version;
//   2. conv1 on the Hopper conv core (csrc/conv3x3_sm90.cuh) over the one
//      map up: per tap, up's 64-channel TMA boxes against the packed w1
//      (F, 9, Cx);
//   3. conv2 on the same core over y1.
// Both convs take bias + ReLU in the epilogue; up and y1 go through device
// memory (y1 is kept for the backward in training).  The launch records
// (tiles, grids, tensor maps) are planned on the host
// (kernels/sm90.py::unetup_launches at Cs = 0: 256 x 64 tiles, persistent,
// at both heads).
//
// Bound on the H100: operations (309 GFLOP at the unet_resnet50 head,
// 8x256x256x64 -> 8x512x512x64, 0.31 ms at 989 TFLOP/s; 1237 GFLOP, 1.25
// ms, at self_net's 8x512x512x64 -> 8x1024x1024x64).  Storing up costs
// one bf16 write and read of conv1's input (0.27 GB at the unet_resnet50
// head, 1.07 GB at self_net's); the lerp inside the ring would save it.
#include "conv3x3.cuh"
#include "conv3x3_sm90.cuh"
#include "upsample_adjoint.cuh"
#include "wgrad.cuh"

using tu::bf16;

// up (B, H2, W2, Cx) = up2x(x); plan: conv1's and conv2's launch records
// (kernels/sm90.py::encode), both OP_FWD over one input map.
extern "C" int tu_upconv(const bf16* up, const bf16* w1, const float* b1, const bf16* w2,
                         const float* b2, bf16* y1, bf16* out, int B, int H2, int W2, int Cx,
                         int F, const int64_t* plan, cudaStream_t stream) {
  namespace sm90 = tu::sm90;
  const sm90::Launch l1{plan}, l2{plan + sm90::PLAN_WORDS};
  // each record's input map is the tensor it is given: (C, W2, H2, B)
  auto fits = [&](const int64_t* m, int C) {
    return m[1] == C && m[2] == W2 && m[3] == H2 && m[4] == B;
  };
  if (l1.op() != sm90::OP_FWD || l2.op() != sm90::OP_FWD || l1.has_map(2) || l2.has_map(2) ||
      !fits(l1.map(0), Cx) || !fits(l2.map(0), F))
    return cudaErrorInvalidValue;
  cudaError_t e = sm90::launch_conv_sm90(
      l1.w, up, nullptr, w1, sm90::ConvArgs{b1, nullptr, y1, nullptr, H2, W2, Cx, F}, stream);
  if (e != cudaSuccess) return e;
  return sm90::launch_conv_sm90(
      l2.w, y1, nullptr, w2, sm90::ConvArgs{b2, nullptr, out, nullptr, H2, W2, F, F}, stream);
}

// tu_upconv_bwd: the head's backward for training, from the forward's out,
// y1 and x and the output gradient g (B, 2H, 2W, F) —
//   g2   = g * [out > 0]                          (conv2's ReLU)
//   dz1  = conv3x3(g2, flipT(w2)) * [y1 > 0]      (conv2 dgrad, conv1's ReLU)
//   dups = conv3x3(dz1, flipT(w1))                (conv1 dgrad, Cx channels)
//   dk2, db2 = wgrad(y1, g2); dk1, db1 = wgrad(up2x(x), dz1)   (float32)
//   dx   = the x2 upsample's adjoint of dups      (B, H, W, Cx)
//
// Replaces tpu_unet/kernels/upconv.py::fused_upconv_bwd_impl (the Pallas call
// at upconv.py:475), which runs both ReLU VJPs, both dgrads, both weight
// gradients with their bias sums and the upsample's adjoint in one pass over
// row tiles.  That kernel is a UnetUp stage backward without the skip, built
// from decoder_train.py's helpers, so this port is the stage backward of
// csrc/decoder_train.cu, csrc/unetup_wgrad.cu and csrc/upsample_adjoint.cuh
// at Cs = 0, in one C entry: the dgrad pair on the mma.sync conv core
// (csrc/conv3x3.cuh; the first masks g by out > 0 as its loader gathers
// it and writes g2 once, its epilogue masks by y1 > 0; the second writes
// all its channels to dups), the float32 weight-gradient GEMM of
// csrc/wgrad.cuh for dk2 over y1 and for dk1 over csrc/conv3x3.cuh's
// UpConcatLoader at Cs = 0 (so up2x(x) is lerped as the GEMM gathers it
// and never stored), and the adjoint's gather.  g2, dz1 and dups go
// through device memory; the TPU kernel keeps them in VMEM.  The split-K
// partials are added in split order: bit-identical run to run.
//
// Bound on the H100: operations (four 3x3 GEMM-convs of 2 * 9 * P * 64 * 64
// at P = 8 x 512 x 512, the unet_resnet50 head at batch 8: 618 GFLOP,
// 0.625 ms at 989 TFLOP/s; the least bytes, g, out, y1, x and dx, 0.94 GB,
// 0.28 ms at 3.35 TB/s).  The design is the single-stage mma.sync core
// (csrc/conv3x3.cuh, csrc/wgrad.cuh), at 10% of that bound.  Shapes:
// 2H % 8, 2W % 16, Cx % 64, F % 64 all 0.
// work1 holds ns1 * F * (9 * Cx + 1) floats, work2 ns2 * F * (9 * F + 1).
extern "C" int tu_upconv_bwd(const bf16* g, const bf16* out, const bf16* y1, const bf16* x,
                             const int* ridx, const float* rw, const int* cidx,
                             const float* cw, const int* aridx, const float* arw, int anr,
                             const int* acidx, const float* acw, int anc, const bf16* w2t,
                             const bf16* w1t, bf16* g2, bf16* dz1, bf16* dups, float* work1,
                             float* work2, float* dk1, float* db1, float* dk2, float* db2,
                             bf16* dx, int B, int H2, int W2, int Cx, int F, int ns1, int ns2,
                             cudaStream_t stream) {
  const tu::ReluGradLoader lg{g, out, g2, H2, W2, F};
  cudaError_t e = tu::launch_conv3x3_grad<tu::ReluGradLoader, tu::EPI_MASK>(
      lg, w2t, y1, dz1, nullptr, B, H2, W2, 9 * F, F, F, stream);
  if (e != cudaSuccess) return e;
  // no skip channels: EPI_SPLIT at Fa = 0 writes every channel to dups
  e = tu::launch_conv3x3_grad<tu::NhwcLoader, tu::EPI_SPLIT>(
      tu::NhwcLoader{dz1, H2, W2, F}, w1t, nullptr, nullptr, dups, B, H2, W2, 9 * F, Cx, 0,
      stream);
  if (e != cudaSuccess) return e;
  e = tu::launch_wgrad(tu::NhwcLoader{y1, H2, W2, F}, g2, work2, dk2, db2, B, H2, W2, F, F, ns2,
                       stream);
  if (e != cudaSuccess) return e;
  const tu::UpConcatLoader up{nullptr, x, ridx, rw, cidx, cw, H2, W2, 0, Cx};
  e = tu::launch_wgrad(up, dz1, work1, dk1, db1, B, H2, W2, Cx, F, ns1, stream);
  if (e != cudaSuccess) return e;
  return tu::launch_upsample_adjoint(dups, aridx, arw, anr, acidx, acw, anc, dx, B, H2 / 2,
                                     W2 / 2, Cx, stream);
}
