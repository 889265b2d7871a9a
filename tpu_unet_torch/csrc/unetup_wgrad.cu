// unetup_wgrad: the weight and bias gradients of one UnetUp decoder stage,
// in float32 —
//   dk1[f, c, ky, kx] = sum_p dz1[p, f] * cc[p + (ky - 1, kx - 1), c],
//                       cc = [skip | up2x(x)]  (SAME padding: 0 outside)
//   dk2[f, c, ky, kx] = sum_p g2[p, f] * y1[p + (ky - 1, kx - 1), c]
//   db1[f] = sum_p dz1[p, f],  db2[f] = sum_p g2[p, f]
// over the B * 2H * 2W pixels p, with dz1 and g2 from the dgrad chain
// (csrc/decoder_train.cu).
//
// Replaces the in-kernel weight gradients of
// tpu_unet/kernels/decoder_train.py's stage backwards (#14 / #16 and their
// low-res schedules #15 / #17, _bwd_kernel_v2 :340-374) and #18's repack of
// their paired accumulators (_repack_wgrad, the Pallas call at :1146): in
// natural layout the GEMM writes the (F, Cin, 3, 3) gradient directly.
//
// Three launches of the Hopper weight-gradient GEMM (csrc/wgrad_sm90.cuh,
// each with its split-K reduce pass), per the host plan
// (kernels/sm90.py::unetup_wgrad_launches):
//   dk1[:, :Cs] from (dz1, skip), with db1;
//   dk1[:, Cs:] from (dz1, up), up = up2x(x) written again by the forward's
//               upsample kernel (csrc/decoder_fuse.cu), so its bf16 values
//               are the forward's;
//   dk2         from (g2, y1), with db2.
// The concat [skip | up] is never stored: each reduce pass writes its
// channel range of the one (F, Cs + Cx, 3, 3) dk1.  The partials are added
// in split order, so the result is bit-identical run to run.
//
// Bound on the H100: operations (2 * 9 * P * F * (Cs + Cx + F): 0.63 ms for
// up1 at 512x512, batch 8, at 989 TFLOP/s bf16).
// Shapes: 2H % 8, 2W % 16, F % 64, Cs % 8, Cx % 8 all 0.
#include "wgrad_sm90.cuh"

using bf16 = __nv_bfloat16;
namespace sm90 = tu::sm90;

// plan: three OP_WGRAD launch records (dk1's skip and up channels, dk2;
// each names its channel range and whether it sums the bias gradient);
// work holds, for the largest of them, nsplit * F * (9 * Cp + 1) floats
// (Cp = 64 * ceil(C / 64) of its input).
extern "C" int tu_unetup_wgrad(const bf16* skip, const bf16* up, const bf16* dz1, const bf16* y1,
                               const bf16* g2, float* work, float* dk1, float* db1, float* dk2,
                               float* db2, int B, int H2, int W2, int Cs, int Cx, int F,
                               const int64_t* plan, cudaStream_t stream) {
  const bf16* gouts[3] = {dz1, dz1, g2};
  const bf16* ins[3] = {skip, up, y1};
  const int cs[3] = {Cs, Cx, F};
  float* dks[3] = {dk1, dk1, dk2};
  float* dbs[3] = {db1, db1, db2};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t e = sm90::launch_wgrad_sm90(plan + i * sm90::PLAN_WORDS, gouts[i], ins[i],
                                                  work, dks[i], dbs[i], B, H2, W2, cs[i], F,
                                                  stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
