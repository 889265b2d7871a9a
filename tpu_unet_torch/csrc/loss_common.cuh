// The device epilogue shared by the loss kernels, csrc/loss.cu (#27, #29)
// and csrc/loss_logits.cu (#25, #26): the softmax's exponential, the
// integer ticket that finds a pass's last block, the ordered sum of the
// blocks' partial rows, kernels/loss.py::_finish and ::dice_coefs in the
// same float32 operations.  No float atomics anywhere: a loss is the same
// on every run.
#pragma once

#include "sm90.cuh"

namespace tu {
namespace loss {

constexpr float SMOOTH = 1e-5f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Called by threads 0 .. nthreads - 1 of every block (named barrier `bar`)
// once the block's partial row is written: true in the block that
// finishes last, which then sees every row.  The ticket is 0 before a pass
// and set back to 0 by its last block; `flag` is an int of shared memory.
__device__ __forceinline__ bool last_block(unsigned* ticket, int* flag, int bar, int nthreads) {
  __threadfence();
  sm90::bar_sync(bar, nthreads);
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) *ticket = 0u;
    *flag = last;
  }
  sm90::bar_sync(bar, nthreads);
  if (!*flag) return false;
  __threadfence();
  return true;
}

// column j of the `rows` partial rows of M floats, added in row order
// (32 loads in flight)
__device__ __forceinline__ float row_order_sum(const float* partial, int rows, int M, int j) {
  float s = 0.f;
  for (int r0 = 0; r0 < rows; r0 += 32) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      v[i] = r0 + i < rows ? __ldcg(partial + static_cast<size_t>(r0 + i) * M + j) : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (r0 + i < rows) s += v[i];
  }
  return s;
}

// _finish on the device, by threads 0 .. nthreads - 1 (named barrier
// `bar`), from the sums S = [S0, S1, tp[C], psum[C], tsum[C], tp@0.5[C],
// pos@0.5[C]] in shared memory: the CE term S0 / max(S1, 1e-12), or S0 /
// focal_n for the focal loss (focal_n > 0, the pixel count); writes loss,
// fscore and res[0 .. 2C] = [s_w, denom[C], score[C]].  E: 256 floats of
// shared scratch.
__device__ __forceinline__ void finish(const float* S, int C, int with_dice, float focal_n,
                                       float* loss, float* fscore, float* res, float* E, int bar,
                                       int nthreads) {
  const int tid = threadIdx.x;
  if (tid < C) {
    const float tp = S[2 + tid], ps = S[2 + C + tid], ts = S[2 + 2 * C + tid];
    const float tpt = S[2 + 3 * C + tid], pts = S[2 + 4 * C + tid];
    const float fp = ps - tp, fn = ts - tp;
    const float den = 2.f * tp + fn + fp + SMOOTH;
    const float sc = (2.f * tp + SMOOTH) / den;
    const float fpt = pts - tpt, fnt = ts - tpt;
    res[1 + tid] = den;
    res[1 + C + tid] = sc;
    E[tid] = sc;
    E[128 + tid] = (2.f * tpt + SMOOTH) / (2.f * tpt + fnt + fpt + SMOOTH);
  }
  sm90::bar_sync(bar, nthreads);
  if (tid == 0) {
    float ms = 0.f, mf = 0.f;
    for (int c = 0; c < C; ++c) {
      ms += E[c];
      mf += E[128 + c];
    }
    ms /= static_cast<float>(C);
    mf /= static_cast<float>(C);
    const float ce = S[0] / (focal_n > 0.f ? focal_n : fmaxf(S[1], 1e-12f));
    *loss = with_dice ? ce + (1.f - ms) : ce;
    *fscore = mf;
    res[0] = S[1];
  }
}

// dice_coefs for one class: dL/dp = A·onehot + B, scaled by the cotangent gl
__device__ __forceinline__ void dice_coef(float gl, float denom, float score, int C, float& a,
                                          float& b) {
  const float num = score * denom;
  a = (-(2.f / denom) / static_cast<float>(C)) * gl;
  b = (-(-num / (denom * denom)) / static_cast<float>(C)) * gl;
}

}  // namespace loss
}  // namespace tu
