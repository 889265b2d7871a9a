// vgg_block_bwd: the backward of one VGG16 encoder stage in training — the
// stem (conv1_1 3 -> 64, conv1_2, pool) or a block of 2 or 3 chained 3x3
// conv + ReLU with an optional trailing 2x2 max-pool:
//   g_n   = (dskip + unpool(dpool)) * [out > 0]       (pool and last ReLU)
//   g_i-1 = conv3x3(g_i, flipT(w_i)) * [a_i-1 > 0]    (dgrad, ReLU of a_i-1)
//   dx    = conv3x3(g_0, flipT(w_0))                  (blocks only)
//   dk_i  = sum_p g_i[p] (x) im2col(a_i-1)[p],  db_i = sum_p g_i[p]  (float32)
// with a_-1 = x, a_n-1 = out and SAME padding.  unpool routes each pooled
// gradient to the first maximum of its 2x2 window in row-major order, as
// XLA's select-and-scatter does.
//
// Replaces the one-pass Pallas backwards of the training encoder:
// tpu_unet/kernels/stem_train.py::fused_vgg_stem_bwd_impl (the Pallas call
// at stem_train.py:245, #20), encoder_train.py::fused_vgg_block2_bwd_impl
// (:329, #22) and encoder3_train.py::fused_vgg_block3_bwd_impl (:349, #24).
// The TPU kernels keep each row tile's chain in VMEM, recompute the pool
// routing and accumulate the paired weight gradients in VMEM.  Here the
// chain goes through device memory in natural layout:
//   1. pool_relu_grad: one thread owns a pooled pixel's 2x2 window and 8
//      channels (16-byte loads), picks the first maximum per channel, adds
//      the pooled gradient to the skip's there (one bf16 rounding, as a bf16
//      add) and applies the ReLU mask; without the pool, the mask only
//      (csrc/relu_grad.cuh);
//   2. per conv, last first: the weight gradient through a GEMM over the
//      pixels, then the dgrad through a conv core with the ReLU mask of its
//      input in the epilogue (conv 0 of a block: the plain store to dx).
// Two gradient buffers alternate; the weight-gradient work area is reused
// from conv to conv (one stream orders them).  No atomics, so the result
// is bit-identical run to run.
//
// The blocks (2 convs, #22; 3, #24) run step 2 on the Hopper kernels: the
// weight gradient on csrc/wgrad_sm90.cuh (MN-major wgmma operands straight
// from TMA boxes of g and the input) and the dgrad on csrc/conv3x3_sm90.cuh
// (OP_DGRAD_MASK; conv 0's OP_DGRAD_SPLIT with every channel to dx), per
// the host plan's launch records (kernels/sm90.py::block_bwd_launches;
// the dgrads at the 256-pixel tile where the N tile is at most 128 wide
// and H % 16 == 0).  The stem (#20) runs on the mma.sync core
// (csrc/conv3x3.cuh) and csrc/wgrad.cuh: conv1_2's weight gradient and
// masked dgrad, then conv1_1's weight gradient, its 27 columns padded to
// 64 and gathered from the image by the image loader.  The stem computes
// no image gradient, as JAX's does not.
//
// Bound on the H100: operations — per conv a dgrad and a weight gradient
// of 2 * 9 * P * Cin * Cout each (the stem at 512x512, batch 8: 0.33 ms at
// 989 TFLOP/s bf16; block 2 0.469 ms; blocks 3-5 0.24-0.78 ms).
// Shapes: H % 8, W % 16, widths % 64 (the image's 3 channels apart).
#include "relu_grad.cuh"
#include "wgrad.cuh"
#include "wgrad_sm90.cuh"

namespace tu {
namespace {

// pooled: one thread a (b, py, px, 8 channels) slot of dpool (B, H/2, W/2, C)
__global__ void __launch_bounds__(256)
pool_relu_grad_kernel(const bf16* __restrict__ dskip, const bf16* __restrict__ dpool,
                      const bf16* __restrict__ out, bf16* __restrict__ g, int B, int H, int W,
                      int C) {
  const int cg = C / 8, Hp = H / 2, Wp = W / 2;
  const size_t n = static_cast<size_t>(B) * Hp * Wp * cg;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c = static_cast<int>(idx % cg) * 8;
  size_t r = idx / cg;
  const int px = static_cast<int>(r % Wp);
  r /= Wp;
  const int py = static_cast<int>(r % Hp);
  const int b = static_cast<int>(r / Hp);
  size_t o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = ((static_cast<size_t>(b) * H + 2 * py + (q >> 1)) * W + 2 * px + (q & 1)) * C + c;
  const uint4 pu = ld16(dpool + ((static_cast<size_t>(b) * Hp + py) * Wp + px) * C + c);
  const bf16* pv = reinterpret_cast<const bf16*>(&pu);
  uint4 ou[4], su[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ou[q] = ld16(out + o[q]);
    su[q] = ld16(dskip + o[q]);
  }
  __align__(16) bf16 res[4][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __bfloat162float(reinterpret_cast<const bf16*>(&ou[q])[j]);
    int first = 0;
#pragma unroll
    for (int q = 1; q < 4; ++q)
      if (v[q] > v[first]) first = q;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bf16 s = reinterpret_cast<const bf16*>(&su[q])[j];
      const bf16 t = q == first ? __float2bfloat16_rn(__bfloat162float(s) + __bfloat162float(pv[j]))
                                : s;
      res[q][j] = v[q] > 0.f ? t : __float2bfloat16_rn(0.f);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) *reinterpret_cast<uint4*>(g + o[q]) = *reinterpret_cast<const uint4*>(res[q]);
}

}  // namespace
}  // namespace tu

using tu::bf16;

// chans[0..n] the widths (chans[0] == 3 with is_image: x is the bf16 image);
// mids[i] (i < n - 1) the ReLU outputs between the convs, out the last one;
// wts[i] the dgrad weights flipT(w_i) packed (Cin_i, 9 * Cout_i), wts[0]
// unused without dx; dpool null without the pool; ga, gb (B, H, W, C_n)
// scratch; work holds max_i ns[i] * C_i+1 * (wgrad_k(C_i) + 1) floats;
// plan: for a block, 2n launch records (conv i's weight gradient at 2i,
// its dgrad at 2i + 1), null for the stem; ns: the stem's split counts.
extern "C" int tu_vgg_block_bwd(const bf16* x, int is_image, const bf16* mid0, const bf16* mid1,
                                const bf16* out, const bf16* dskip, const bf16* dpool,
                                const bf16* wt0, const bf16* wt1, const bf16* wt2, bf16* ga,
                                bf16* gb, bf16* dx, float* work, float* dk0, float* dk1,
                                float* dk2, float* db0, float* db1, float* db2, int n, int B,
                                int H, int W, int c0, int c1, int c2, int c3, int ns0, int ns1,
                                int ns2, const int64_t* plan, cudaStream_t stream) {
  namespace sm90 = tu::sm90;
  const bf16* mids[2] = {mid0, mid1};
  const bf16* wts[3] = {wt0, wt1, wt2};
  float* dks[3] = {dk0, dk1, dk2};
  float* dbs[3] = {db0, db1, db2};
  const int chans[4] = {c0, c1, c2, c3};
  const int C = chans[n];
  cudaError_t e;
  if (dpool != nullptr) {
    const size_t m = static_cast<size_t>(B) * (H / 2) * (W / 2) * (C / 8);
    tu::pool_relu_grad_kernel<<<static_cast<unsigned>((m + 255) / 256), 256, 0, stream>>>(
        dskip, dpool, out, ga, B, H, W, C);
    e = cudaGetLastError();
  } else {
    e = tu::launch_relu_grad(dskip, out, ga, static_cast<size_t>(B) * H * W * (C / 8), stream);
  }
  if (e != cudaSuccess) return e;
  bf16* g = ga;
  bf16* g_next = gb;
  if (is_image) {  // the stem (#20): conv1_2, then conv1_1's weight gradient over the image
    if (n != 2 || plan != nullptr || dx != nullptr) return cudaErrorInvalidValue;
    e = tu::launch_wgrad(tu::NhwcLoader{mid0, H, W, c1}, g, work, dk1, db1, B, H, W, c1, c2, ns1,
                         stream);
    if (e != cudaSuccess) return e;
    e = tu::launch_conv3x3_grad<tu::NhwcLoader, tu::EPI_MASK>(
        tu::NhwcLoader{g, H, W, c2}, wt1, mid0, g_next, nullptr, B, H, W, 9 * c2, c1, c1, stream);
    if (e != cudaSuccess) return e;
    return tu::launch_wgrad(tu::ImageLoader<false>{x, H, W}, g_next, work, dk0, db0, B, H, W, 3,
                            c1, ns0, stream);
  }
  if (plan == nullptr) return cudaErrorInvalidValue;
  for (int i = n - 1; i >= 0; --i) {
    const int cin = chans[i], cout = chans[i + 1];
    const int64_t* wrec = plan + (2 * i) * sm90::PLAN_WORDS;
    const int64_t* drec = plan + (2 * i + 1) * sm90::PLAN_WORDS;
    e = sm90::launch_wgrad_sm90(wrec, g, i == 0 ? x : mids[i - 1], work, dks[i], dbs[i], B, H, W,
                                cin, cout, stream);
    if (e != cudaSuccess) return e;
    if (i > 0) {
      if (drec[0] != sm90::OP_DGRAD_MASK) return cudaErrorInvalidValue;
      e = sm90::launch_conv_sm90(
          drec, g, nullptr, wts[i],
          sm90::ConvArgs{nullptr, mids[i - 1], g_next, nullptr, H, W, cout, cin}, stream);
    } else if (dx != nullptr) {
      if (drec[0] != sm90::OP_DGRAD_SPLIT || sm90::Launch{drec}.split() != cin)
        return cudaErrorInvalidValue;
      e = sm90::launch_conv_sm90(drec, g, nullptr, wts[0],
                                 sm90::ConvArgs{nullptr, nullptr, dx, nullptr, H, W, cout, cin},
                                 stream);
    }
    if (e != cudaSuccess) return e;
    bf16* t = g;
    g = g_next;
    g_next = t;
  }
  return cudaSuccess;
}
