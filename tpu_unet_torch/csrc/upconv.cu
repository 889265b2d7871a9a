// upconv: the up_conv head of unet_resnet50 and self_net, forward and
// backward, both on the Hopper kernels.  Forward (tu_upconv) —
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
#include "relu_grad.cuh"
#include "upsample_adjoint.cuh"
#include "wgrad_sm90.cuh"

using bf16 = __nv_bfloat16;

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

// tu_upconv_bwd: the head's backward for training, from the forward's out
// and y1, up = up2x(x) and the output gradient g (B, 2H, 2W, F) —
//   g2   = g * [out > 0]                          (conv2's ReLU)
//   dz1  = conv3x3(g2, flipT(w2)) * [y1 > 0]      (conv2 dgrad, conv1's ReLU)
//   dups = conv3x3(dz1, flipT(w1))                (conv1 dgrad, Cx channels)
//   dk2, db2 = wgrad(y1, g2); dk1, db1 = wgrad(up, dz1)   (float32)
//   dx   = the x2 upsample's adjoint of dups      (B, H, W, Cx)
//
// Replaces tpu_unet/kernels/upconv.py::fused_upconv_bwd_impl (the Pallas call
// at upconv.py:475), which runs both ReLU VJPs, both dgrads, both weight
// gradients with their bias sums and the upsample's adjoint in one pass over
// row tiles.  That kernel is a UnetUp stage backward without the skip, built
// from decoder_train.py's helpers, so this port is the stage backward of
// csrc/decoder_train.cu, csrc/unetup_wgrad.cu and csrc/upsample_adjoint.cuh
// at Cs = 0, six launches in one C entry per the host plan
// (kernels/sm90.py::upconv_bwd_launches):
//   1. the ReLU mask pass (csrc/relu_grad.cuh) writes g2: the conv core
//      reads its operand by TMA, which cannot mask;
//   2. conv2's dgrad on the Hopper conv core (csrc/conv3x3_sm90.cuh) over
//      g2 with flipT(w2), its epilogue masking by y1 > 0 (OP_DGRAD_MASK)
//      into dz1;
//   3. dk2 / db2 on the Hopper weight-gradient GEMM (csrc/wgrad_sm90.cuh)
//      over (g2, y1), with its split-K reduce pass: g2's last read;
//   4. conv1's dgrad on the conv core over dz1 with flipT(w1) into dups,
//      the split store at split = Cx (OP_DGRAD_SPLIT with every channel to
//      its first output, as a VGG block's conv 0 writes dx; the core takes
//      0 < split <= F, and a stage at Cs = 0 would split at 0).  dups may
//      take g2's memory, so the head's backward holds one activation
//      gradient less at the training step's peak (1.07 GB at self_net's);
//   5. dk1 / db1 the same over (dz1, up); up is written by one more launch
//      of the upsample kernel (the wrapper's, launch key upsample2x), as a
//      decoder stage's weight gradients take it, so the training step
//      keeps no `up` from the forward to the backward;
//   6. the adjoint's gather (csrc/upsample_adjoint.cuh) writes dx.
// g2, dz1 and dups go through device memory; the TPU kernel keeps them in
// VMEM.  Both dgrads at the tile of conv_tile_m (256 x 64, persistent, at
// both heads); the GEMMs at 64 f x 128 columns, their splits filling the
// 132 SMs, each split at most 1280 patches of 8 x 16 pixels
// (sm90.py::MAX_SPLIT_PATCHES: 52 splits at self_net's 8.4M pixels, whose
// float32 runs at 23 splits read dk2 3.8e-4 of max |dk2| from float64 on
// an H100); the partials are added in split order, so the result is
// bit-identical run to run.
//
// Bound on the H100: operations (four 3x3 GEMM-convs of 2 * 9 * P * 64 * 64
// at P = 8 x 512 x 512, the unet_resnet50 head at batch 8: 618 GFLOP,
// 0.625 ms at 989 TFLOP/s; self_net's at 8 x 1024 x 1024, 2.50 ms; the
// least bytes, g, out, y1, x and dx, 0.94 GB, 0.28 ms at 3.35 TB/s).  The
// mask pass moves 6 bytes a value and the stored up 4 (0.25 / 0.16 ms at
// the unet_resnet50 head).  Shapes: 2H % 8, 2W % 16, Cx % 64, F % 64 all 0.
// plan: four launch records, conv2's dgrad (OP_DGRAD_MASK), conv1's
// (OP_DGRAD_SPLIT at Cx), dk2's GEMM and dk1's (OP_WGRAD); work holds the
// larger GEMM's nsplit * F * (9 * tap_width(C) + 1) floats; dups may share
// g2's memory (it is written after g2's last read).
extern "C" int tu_upconv_bwd(const bf16* g, const bf16* out, const bf16* y1, const bf16* up,
                             const int* aridx, const float* arw, int anr, const int* acidx,
                             const float* acw, int anc, const bf16* w2t, const bf16* w1t,
                             bf16* g2, bf16* dz1, bf16* dups, float* work, float* dk1,
                             float* db1, float* dk2, float* db2, bf16* dx, int B, int H2,
                             int W2, int Cx, int F, const int64_t* plan, cudaStream_t stream) {
  namespace sm90 = tu::sm90;
  if (plan == nullptr) return cudaErrorInvalidValue;
  const int64_t* r2 = plan;
  const int64_t* r1 = plan + sm90::PLAN_WORDS;
  if (r2[0] != sm90::OP_DGRAD_MASK || r1[0] != sm90::OP_DGRAD_SPLIT ||
      sm90::Launch{r1}.split() != Cx)
    return cudaErrorInvalidValue;
  cudaError_t e =
      tu::launch_relu_grad(g, out, g2, static_cast<size_t>(B) * H2 * W2 * (F / 8), stream);
  if (e != cudaSuccess) return e;
  e = sm90::launch_conv_sm90(r2, g2, nullptr, w2t,
                             sm90::ConvArgs{nullptr, y1, dz1, nullptr, H2, W2, F, F}, stream);
  if (e != cudaSuccess) return e;
  e = sm90::launch_wgrad_sm90(plan + 2 * sm90::PLAN_WORDS, g2, y1, work, dk2, db2, B, H2, W2, F,
                              F, stream);
  if (e != cudaSuccess) return e;
  e = sm90::launch_conv_sm90(r1, dz1, nullptr, w1t,
                             sm90::ConvArgs{nullptr, nullptr, dups, nullptr, H2, W2, F, Cx},
                             stream);
  if (e != cudaSuccess) return e;
  e = sm90::launch_wgrad_sm90(plan + 3 * sm90::PLAN_WORDS, dz1, up, work, dk1, db1, B, H2, W2,
                              Cx, F, stream);
  if (e != cudaSuccess) return e;
  return tu::launch_upsample_adjoint(dups, aridx, arw, anr, acidx, acw, anc, dx, B, H2 / 2,
                                     W2 / 2, Cx, stream);
}
