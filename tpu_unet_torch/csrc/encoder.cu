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
// Every conv runs on the Hopper core (csrc/conv3x3_sm90.cuh: wgmma, TMA, an
// mbarrier ring), one launch record each from the host plan (kernels/
// sm90.py::block_fwd_launches): OP_FWD, and OP_FWD_POOL for the last conv
// of a pooling block, at the plan's tile.  Block 2 (64 -> 128 -> 128) runs
// both convs at 256 pixels x 128 channels (85 FLOP a byte of L2, 4 stages
// of 48 KB, a block a tile; the pool epilogue takes either patch height):
// on an H100 14% (conv 1) and 20% (conv 2) faster than the persistent
// 128-pixel tile (64 FLOP a byte, 5 stages).
//
// In bf16 or, for the float32 training path, float32 (the conv core's
// float32 instantiation: TF32 products, float32 storage).
//
// Bound on the H100: compute (116-387 GFLOP per block at 512x512, batch 8;
// 0.12-0.39 ms at 989 TFLOP/s); the intermediates add 2-4 bytes of traffic
// per multiply-add of several hundred, so fusing them is a later gain.
#include "conv3x3_sm90.cuh"

using bf16 = __nv_bfloat16;

namespace {

template <typename T>
int vgg_block(const T* x, int n_convs, const T* const* ws, const float* const* bs, T* const* mids,
              T* skip, T* pooled, int B, int H, int W, const int* chans, const int64_t* plan,
              cudaStream_t stream) {
  const T* in = x;
  for (int i = 0; i < n_convs; ++i) {
    const bool last = i == n_convs - 1;
    const bool pool = last && pooled != nullptr;
    T* out = last ? skip : mids[i];
    const int64_t* rec = plan + i * tu::sm90::PLAN_WORDS;
    if (rec[0] != (pool ? tu::sm90::OP_FWD_POOL : tu::sm90::OP_FWD)) return cudaErrorInvalidValue;
    const tu::sm90::ConvArgsT<T> a{bs[i], nullptr, out, pool ? pooled : nullptr, H, W, chans[i],
                                   chans[i + 1]};
    const cudaError_t e = tu::sm90::launch_conv_sm90<T>(rec, in, nullptr, ws[i], a, stream);
    if (e != cudaSuccess) return e;
    in = out;
  }
  return cudaSuccess;
}

template <typename T>
int vgg_block_typed(const void* x, int n_convs, const void* w0, const void* w1, const void* w2,
                    const float* const* bs, void* mid0, void* mid1, void* skip, void* pooled,
                    int B, int H, int W, const int* chans, const int64_t* plan,
                    cudaStream_t stream) {
  const T* ws[3] = {static_cast<const T*>(w0), static_cast<const T*>(w1),
                    static_cast<const T*>(w2)};
  T* mids[2] = {static_cast<T*>(mid0), static_cast<T*>(mid1)};
  return vgg_block<T>(static_cast<const T*>(x), n_convs, ws, bs, mids, static_cast<T*>(skip),
                      static_cast<T*>(pooled), B, H, W, chans, plan, stream);
}

}  // namespace

// plan: n_convs launch records (kernels/sm90.py::encode), one per conv,
// naming the element type of x, the packed weights, the intermediates,
// skip and pooled (bf16, or float32 with f32); the biases float32.
extern "C" int tu_vgg_block(const void* x, int n_convs, const void* w0, const void* w1,
                            const void* w2, const float* b0, const float* b1, const float* b2,
                            void* mid0, void* mid1, void* skip, void* pooled, int B, int H, int W,
                            int c0, int c1, int c2, int c3, int f32, const int64_t* plan,
                            cudaStream_t stream) {
  if (plan == nullptr || n_convs < 2 || n_convs > 3) return cudaErrorInvalidValue;
  const float* bs[3] = {b0, b1, b2};
  const int chans[4] = {c0, c1, c2, c3};
  return (f32 ? vgg_block_typed<float> : vgg_block_typed<bf16>)(
      x, n_convs, w0, w1, w2, bs, mid0, mid1, skip, pooled, B, H, W, chans, plan, stream);
}
