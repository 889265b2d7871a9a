// unetup_bwd: the activation-gradient chain of one UnetUp decoder stage —
//   g2          = g * [out > 0]                       (conv2's ReLU)
//   dz1         = conv3x3(g2, flipT(w2)) * [y1 > 0]   (conv2 dgrad, conv1's ReLU)
//   [dskip|dups] = conv3x3(dz1, flipT(w1))           (conv1 dgrad, split at Cs)
// with SAME 3x3 convs and no bias; flipT flips (ky, kx) and swaps the input
// and output channels (the host packs it).
//
// Replaces tpu_unet/kernels/decoder_train.py::fused_unetup_bwd_impl (the
// Pallas call at decoder_train.py:140).  The TPU kernel keeps dz1 in VMEM
// between the two dgrads and writes g2 and dz1 out for the XLA weight
// gradients.  Here the chain is two launches of the conv core
// (csrc/conv3x3.cuh): the first masks g by out > 0 in its operand loader
// (g2 is never a separate pass; the centre tap writes it once) and masks
// its result by y1 > 0 in the epilogue; the second reads dz1 and writes
// channels [0, Cs) and [Cs, Cs + Cx) of its result into dskip and dups.
//
// Bound on the H100: compute (618.5 GFLOP for up1 at 512x512, batch 8,
// Cs 64, Cx 128, F 64: 0.63 ms at 989 TFLOP/s; 2.15 GB moved, 0.64 ms at
// 3.35 TB/s).  The design runs both dgrads on the tensor cores through the
// same single-stage mma.sync core as the forward, so it reaches the same
// share of the peak.  Shapes: 2H % 8, 2W % 16, F % 64, (Cs + Cx) % 64,
// Cs % 8 all 0.
#include "conv3x3.cuh"

using tu::bf16;

extern "C" int tu_unetup_bwd(const bf16* g, const bf16* out, const bf16* y1, const bf16* w2t,
                             const bf16* w1t, bf16* g2, bf16* dz1, bf16* dskip, bf16* dups,
                             int B, int H2, int W2, int Cs, int Cx, int F,
                             cudaStream_t stream) {
  const tu::ReluGradLoader ld{g, out, g2, H2, W2, F};
  cudaError_t e = tu::launch_conv3x3_grad<tu::ReluGradLoader, tu::EPI_MASK>(
      ld, w2t, y1, dz1, nullptr, B, H2, W2, 9 * F, F, F, stream);
  if (e != cudaSuccess) return e;
  return tu::launch_conv3x3_grad<tu::NhwcLoader, tu::EPI_SPLIT>(
      tu::NhwcLoader{dz1, H2, W2, F}, w1t, nullptr, dskip, dups, B, H2, W2, 9 * F, Cs + Cx,
      Cs, stream);
}
