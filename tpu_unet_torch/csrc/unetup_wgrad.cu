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
// In bf16 or, for the float32 training path, float32 inputs (the float32
// GEMM of csrc/wgrad_sm90.cuh, TF32 wgmma with G restaged K-major).
//
// Bound on the H100: operations (2 * 9 * P * F * (Cs + Cx + F): 0.63 ms for
// up1 at 512x512, batch 8, at 989 TFLOP/s bf16).
// Shapes: 2H % 8, 2W % 16, F % 64, Cs % 8, Cx % 8 all 0.
#include "wgrad_sm90.cuh"

using bf16 = __nv_bfloat16;
namespace sm90 = tu::sm90;

namespace {

template <typename T>
int unetup_wgrad(const void* skip, const void* up, const void* dz1, const void* y1,
                 const void* g2, float* work, float* dk1, float* db1, float* dk2, float* db2,
                 int B, int H2, int W2, int Cs, int Cx, int F, const int64_t* plan,
                 cudaStream_t stream) {
  const void* gouts[3] = {dz1, dz1, g2};
  const void* ins[3] = {skip, up, y1};
  const int cs[3] = {Cs, Cx, F};
  float* dks[3] = {dk1, dk1, dk2};
  float* dbs[3] = {db1, db1, db2};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t e = sm90::launch_wgrad_sm90<T>(
        plan + i * sm90::PLAN_WORDS, static_cast<const T*>(gouts[i]),
        static_cast<const T*>(ins[i]), work, dks[i], dbs[i], B, H2, W2, cs[i], F, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// plan: three OP_WGRAD launch records (dk1's skip and up channels, dk2;
// each names its channel range, whether it sums the bias gradient and the
// element type of skip, up, dz1, y1 and g2: bf16, or float32 with f32);
// work holds, for the largest of them, nsplit * F * (9 * Cp + 1) floats
// (Cp the input's tap width: C padded to 64).
extern "C" int tu_unetup_wgrad(const void* skip, const void* up, const void* dz1, const void* y1,
                               const void* g2, float* work, float* dk1, float* db1, float* dk2,
                               float* db2, int B, int H2, int W2, int Cs, int Cx, int F, int f32,
                               const int64_t* plan, cudaStream_t stream) {
  return (f32 ? unetup_wgrad<float> : unetup_wgrad<bf16>)(skip, up, dz1, y1, g2, work, dk1, db1,
                                                          dk2, db2, B, H2, W2, Cs, Cx, F, plan,
                                                          stream);
}

// One launch of the weight-gradient GEMM alone (its partials and reduce
// pass) per its OP_WGRAD record: dk (F, Ctot, 3, 3) channels [coff, coff +
// C) and, where the record asks, db (F) from gout (B, H, W, F) and in (B,
// H, W, C) of the record's element type; work as tu_unetup_wgrad's.  For
// the checks and timings of the GEMM at one shape (kernels/decoder_train.py::
// wgrad_gemm).
extern "C" int tu_wgrad(const void* gout, const void* in, float* work, float* dk, float* db,
                        int B, int H, int W, int C, int F, int f32, const int64_t* record,
                        cudaStream_t stream) {
  return f32 ? sm90::launch_wgrad_sm90<float>(record, static_cast<const float*>(gout),
                                              static_cast<const float*>(in), work, dk, db, B, H, W,
                                              C, F, stream)
             : sm90::launch_wgrad_sm90<bf16>(record, static_cast<const bf16*>(gout),
                                             static_cast<const bf16*>(in), work, dk, db, B, H, W,
                                             C, F, stream);
}
