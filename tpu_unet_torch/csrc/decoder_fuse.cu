// unetup: one UnetUp decoder stage, forward —
//   relu(conv2(relu(conv1(concat[skip, up2x_align_corners(x)]))))
// with both convs 3x3 SAME.
//
// Replaces tpu_unet/kernels/decoder_fuse.py::_fused_unetup_fwd_impl (the
// Pallas call at decoder_fuse.py:1149).  On the TPU neither the x2
// upsampled tensor nor the concat reaches HBM.  Here the stage is three
// launches:
//   1. tu_upsample2x writes up = up2x(x) (B, 2H, 2W, Cx) in bf16, once:
//      one thread an output pixel's 8 channels, 16-byte loads and stores,
//      the lerp of csrc/upsample2x.cuh::up2x_lerp8 (bit-equal to the plain
//      version).  Bound by bytes: it reads x and writes up, a quarter of
//      the stage's activation traffic at most;
//   2. conv1 on the Hopper conv core (csrc/conv3x3_sm90.cuh) over two input
//      maps: per tap, the skip's 64-channel TMA boxes, then up's, against
//      the packed w1 (F, 9, Cs + Cx) at each slice's channel offset.  The
//      concat [skip | up] is never stored;
//   3. conv2 on the same core over y1.
// y1 and up go through device memory; both convs take bias + ReLU in the
// epilogue.  The launch records (tiles, grids, tensor maps) are planned on
// the host (kernels/sm90.py::unetup_launches).
//
// Bound on the H100: operations (464-619 GFLOP per stage at 512x512,
// batch 8; 0.47-0.63 ms at 989 TFLOP/s).  Writing up costs one extra
// bf16 pass over the up half of conv1's input (about 2 bytes a pixel and
// channel of 9 * Ct * 2 FLOP); the lerp inside the ring (a producer
// warpgroup filling the up slices from TMA boxes of x) would save it.
#include "conv3x3_sm90.cuh"
#include "upsample2x.cuh"

using bf16 = __nv_bfloat16;

namespace {

// one thread an output pixel's 8 channels of up (B, H2, W2, Cx); n, the
// count of such slots, below 2^32 (the wrapper checks), so the decode is
// 32-bit
__global__ void __launch_bounds__(256)
upsample2x_kernel(const bf16* __restrict__ x, const int* __restrict__ ridx,
                  const float* __restrict__ rw, const int* __restrict__ cidx,
                  const float* __restrict__ cw, bf16* __restrict__ up, unsigned n,
                  unsigned H2, unsigned W2, unsigned Cx) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const unsigned cg = Cx / 8, r = idx / cg, q = r / W2;
  const unsigned c = (idx - r * cg) * 8, ux = r - q * W2, b = q / H2, uy = q - b * H2;
  *reinterpret_cast<uint4*>(up + static_cast<size_t>(idx) * 8) = tu::up2x_lerp8(
      x, ridx, rw, cidx, cw, static_cast<int>(H2), static_cast<int>(W2), static_cast<int>(Cx),
      static_cast<int>(b), static_cast<int>(uy), static_cast<int>(ux), static_cast<int>(c));
}

}  // namespace

// x (B, H2/2, W2/2, Cx) -> up (B, H2, W2, Cx), bf16; Cx % 8 == 0 and
// B * H2 * W2 * Cx / 8 < 2^32.
extern "C" int tu_upsample2x(const bf16* x, const int* ridx, const float* rw, const int* cidx,
                             const float* cw, bf16* up, int B, int H2, int W2, int Cx,
                             cudaStream_t stream) {
  const unsigned long long n = static_cast<unsigned long long>(B) * H2 * W2 * (Cx / 8);
  if (n >= (1ull << 32)) return cudaErrorInvalidValue;
  upsample2x_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      x, ridx, rw, cidx, cw, up, static_cast<unsigned>(n), H2, W2, Cx);
  return cudaGetLastError();
}

// plan: conv1's and conv2's launch records (kernels/sm90.py::encode), both
// OP_FWD; conv1's with the up map as its second input map.
extern "C" int tu_unetup(const bf16* skip, const bf16* up, const bf16* w1, const float* b1,
                         const bf16* w2, const float* b2, bf16* y1, bf16* out, int B, int H2,
                         int W2, int Cs, int Cx, int F, const int64_t* plan,
                         cudaStream_t stream) {
  const tu::sm90::Launch l1{plan}, l2{plan + tu::sm90::PLAN_WORDS};
  // each record's input maps are the tensors it is given: (C, W2, H2, B)
  auto fits = [&](const int64_t* m, int C) {
    return m[1] == C && m[2] == W2 && m[3] == H2 && m[4] == B;
  };
  if (l1.op() != tu::sm90::OP_FWD || l2.op() != tu::sm90::OP_FWD || !fits(l1.map(0), Cs) ||
      !fits(l1.map(2), Cx) || !fits(l2.map(0), F))
    return cudaErrorInvalidValue;
  cudaError_t e = tu::sm90::launch_conv_sm90(
      l1.w, skip, up, w1, tu::sm90::ConvArgs{b1, nullptr, y1, nullptr, H2, W2, Cs, F, Cx},
      stream);
  if (e != cudaSuccess) return e;
  return tu::sm90::launch_conv_sm90(
      l2.w, y1, nullptr, w2, tu::sm90::ConvArgs{b2, nullptr, out, nullptr, H2, W2, F, F}, stream);
}
