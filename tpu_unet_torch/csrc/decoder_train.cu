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
// gradients.  Here the chain is three launches, per the host plan
// (kernels/sm90.py::unetup_bwd_launches):
//   1. the ReLU mask pass (csrc/relu_grad.cuh) writes g2: the Hopper conv
//      core reads its operand by TMA, which cannot mask, and unetup_wgrad
//      reads g2 for dk2 and db2 anyway;
//   2. conv2's dgrad on the Hopper conv core (csrc/conv3x3_sm90.cuh:
//      wgmma, TMA ring) over g2's map with flipT(w2) packed (F, 9F), its
//      epilogue masking by y1 > 0 (OP_DGRAD_MASK) into dz1;
//   3. conv1's dgrad on the same core over dz1's map with flipT(w1) packed
//      (Cs + Cx, 9F), its epilogue sending output channel chunk n to dskip
//      when n < Cs and to dups otherwise (OP_DGRAD_SPLIT at Cs).
// Both dgrads take the plan's tile: conv2's 256 pixels where F <= 128 and
// 2H % 16 == 0 (a decoder's up1 and up2), else 128; conv1's at up1 and up2
// (Cs + Cx = 192, 384) 128 x 192 tiles rather than three tiles of 64 or
// 128 channels, which re-read each dz1 box three times (19% and 13% faster
// on an H100).  Those tiles and conv2's at up1 (256 x 64) run persistent
// (a block an SM walks the tiles, the next tile's loads overlapping the
// epilogue): their 9- and 18-slice K walks are too short to hide the
// ring's fill otherwise.  The mask epilogue loads a thread's mask chunks
// at once, before the store loop.
//
// In bf16 or, for the float32 training path, float32 (the mask pass and
// the conv core's float32 instantiations).
//
// Bound on the H100: the larger of the operations — the two dgrads have
// the forward's FLOPs, 2 * 9 * P * F * (F + Cs + Cx) — and the bytes (g,
// out, y1 read, g2, dz1, dskip, dups written once).  At up1 the bytes:
// 2.15 GB at 512x512, batch 8 (Cs 64, Cx 128, F 64), 0.641 ms at 3.35
// TB/s against 0.625 ms of operations at 989 TFLOP/s bf16 (rn50 up1 0.160
// ms); elsewhere the operations: vgg up4 / up3 / up2 0.469 / 0.625 / 0.625
// ms, rn50 up4 / up3 / up2 0.274 / 0.195 / 0.195.  The mask pass moves 6
// bytes a value (0.24 ms at vgg up1).
// Shapes: 2H % 8, 2W % 16, F % 64, (Cs + Cx) % 64, Cs % 8 all 0.
#include "conv3x3_sm90.cuh"
#include "relu_grad.cuh"

using bf16 = __nv_bfloat16;
namespace sm90 = tu::sm90;

namespace {

template <typename T>
int unetup_bwd(const void* g, const void* out, const void* y1, const void* w2t, const void* w1t,
               void* g2, void* dz1, void* dskip, void* dups, int B, int H2, int W2, int Cs,
               int Cx, int F, const int64_t* plan, cudaStream_t stream) {
  const int64_t* r2 = plan;
  const int64_t* r1 = plan + sm90::PLAN_WORDS;
  if (r2[0] != sm90::OP_DGRAD_MASK || r1[0] != sm90::OP_DGRAD_SPLIT ||
      sm90::Launch{r1}.split() != Cs)
    return cudaErrorInvalidValue;
  T* tg2 = static_cast<T*>(g2);
  T* tdz1 = static_cast<T*>(dz1);
  cudaError_t e = tu::launch_relu_grad<T>(static_cast<const T*>(g), static_cast<const T*>(out),
                                          tg2, static_cast<size_t>(B) * H2 * W2 * F /
                                                   (16 / sizeof(T)), stream);
  if (e != cudaSuccess) return e;
  e = sm90::launch_conv_sm90<T>(
      r2, tg2, nullptr, static_cast<const T*>(w2t),
      sm90::ConvArgsT<T>{nullptr, static_cast<const T*>(y1), tdz1, nullptr, H2, W2, F, F},
      stream);
  if (e != cudaSuccess) return e;
  return sm90::launch_conv_sm90<T>(
      r1, tdz1, nullptr, static_cast<const T*>(w1t),
      sm90::ConvArgsT<T>{nullptr, nullptr, static_cast<T*>(dskip), nullptr, H2, W2, F, Cs + Cx, 0,
                         static_cast<T*>(dups)},
      stream);
}

}  // namespace

// plan: two conv launch records, conv2's dgrad (OP_DGRAD_MASK) then
// conv1's (OP_DGRAD_SPLIT at Cs); w2t = flipT(w2) packed (F, 9F), w1t =
// flipT(w1) packed (Cs + Cx, 9F); every tensor of the element type the
// records name (bf16, or float32 with f32).
extern "C" int tu_unetup_bwd(const void* g, const void* out, const void* y1, const void* w2t,
                             const void* w1t, void* g2, void* dz1, void* dskip, void* dups,
                             int B, int H2, int W2, int Cs, int Cx, int F, int f32,
                             const int64_t* plan, cudaStream_t stream) {
  return (f32 ? unetup_bwd<float> : unetup_bwd<bf16>)(g, out, y1, w2t, w1t, g2, dz1, dskip, dups,
                                                      B, H2, W2, Cs, Cx, F, plan, stream);
}
