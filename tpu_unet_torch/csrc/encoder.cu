// vgg_block: VGG16 blocks 2-5 — 2 or 3 chained 3x3 conv + ReLU, the last
// one optionally followed by the 2x2 max-pool.
//
// Replaces tpu_unet/kernels/encoder.py::fused_vgg_block_impl (the Pallas
// call at encoder.py:288) and, keeping its intermediates for training,
// encoder_train.py::fused_vgg_block2_fwd_impl (:139, two convs) and
// encoder3_train.py::fused_vgg_block3_fwd_impl (:279, three).  The TPU
// kernels keep the chain's intermediate activations in VMEM; here each
// conv is one launch and the intermediates go through device memory (the
// wrapper hands in the buffers).  The pool is fused into the last conv's
// epilogue, so the skip and the pooled tensor come from one pass, as on
// the TPU.
//
// Three convs (blocks 3-5) run on the Hopper core (csrc/conv3x3_sm90.cuh:
// wgmma, TMA, an mbarrier ring), one launch record each from the host plan
// (kernels/sm90.py); two (block 2) on the mma.sync core (csrc/conv3x3.cuh).
//
// Bound on the H100: compute (116-387 GFLOP per block at 512x512, batch 8;
// 0.12-0.39 ms at 989 TFLOP/s); the intermediates add 2-4 bytes of traffic
// per multiply-add of several hundred, so fusing them is a later gain.
#include "conv3x3.cuh"
#include "conv3x3_sm90.cuh"

using tu::bf16;

// plan: n_convs launch records (kernels/sm90.py::encode) for three convs,
// null for two.
extern "C" int tu_vgg_block(const bf16* x, int n_convs, const bf16* w0, const bf16* w1,
                            const bf16* w2, const float* b0, const float* b1, const float* b2,
                            bf16* mid0, bf16* mid1, bf16* skip, bf16* pooled, int B, int H,
                            int W, int c0, int c1, int c2, int c3, const int64_t* plan,
                            cudaStream_t stream) {
  const bf16* ws[3] = {w0, w1, w2};
  const float* bs[3] = {b0, b1, b2};
  bf16* mids[2] = {mid0, mid1};
  const int chans[4] = {c0, c1, c2, c3};
  const bf16* in = x;
  for (int i = 0; i < n_convs; ++i) {
    const bool last = i == n_convs - 1;
    bf16* out = last ? skip : mids[i];
    const tu::NhwcLoader ld{in, H, W, chans[i]};
    const int K = 9 * chans[i], F = chans[i + 1];
    cudaError_t e;
    if (n_convs == 3) {
      if (plan == nullptr) return cudaErrorInvalidValue;
      const int64_t* rec = plan + i * tu::sm90::PLAN_WORDS;
      const bool pool = last && pooled != nullptr;
      if (rec[0] != (pool ? tu::sm90::OP_FWD_POOL : tu::sm90::OP_FWD))
        return cudaErrorInvalidValue;
      const tu::sm90::ConvArgs a{bs[i], nullptr, out, pool ? pooled : nullptr, H, W, chans[i],
                                 F};
      e = tu::sm90::launch_conv_sm90(rec, in, nullptr, ws[i], a, stream);
    } else if (last && pooled != nullptr)
      e = tu::launch_conv3x3<tu::NhwcLoader, true>(ld, ws[i], bs[i], out, pooled, B, H, W, K, F,
                                                   stream);
    else
      e = tu::launch_conv3x3<tu::NhwcLoader, false>(ld, ws[i], bs[i], out, nullptr, B, H, W, K,
                                                    F, stream);
    if (e != cudaSuccess) return e;
    in = out;
  }
  return cudaSuccess;
}
