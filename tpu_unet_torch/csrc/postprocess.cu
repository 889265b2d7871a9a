// The serving tails: final 1x1 conv (F -> C), per-pixel argmax and uint8
// mask, with (final_argmax_hist) or without (final_argmax) the per-image
// class histogram; the logits are never stored.
//
// Replaces three functions of tpu_unet/kernels/postprocess.py:
//   - fused_final_argmax_hist_paired (the Pallas call at :244), the
//     canonical UNets' tail, F = 64: csrc/tail_sm90.cu, the products on
//     wgmma behind a TMA ring, which the C entries below call at F = 64;
//   - fused_final_argmax_hist (:154), the natural-layout tail of the
//     TraditionalUnet family, F = 32 (traditional) and 22 (traditional22);
//   - fused_final_argmax (:92), the mask-only tail that :148-152 takes when
//     an image's pixel count is not a multiple of the row block.
// Here: one kernel template on the feature width F (22 or 32) and on HIST.
//
// One thread per pixel, 256 pixels a block.  A block's 256 feature rows are
// contiguous in device memory (256 * F * 2 bytes, a multiple of 16), so the
// block stages them into shared memory with coalesced 16-byte loads; a
// pixel's row there is F / 2 32-bit words padded to an odd count, so the 32
// lanes of a warp, each reading word j of its own pixel, hit 32 distinct
// banks.  (At F = 22 a row is 44 bytes, 4-byte aligned only: per-thread
// 16-byte loads from device memory would be misaligned.)  The (F, C)
// weights and the bias sit in shared memory, each class's dot product runs
// in f32 over f = 0 .. F-1, and the argmax keeps the first maximum (strict
// >), as jnp.argmax and torch.argmax do.  The histogram is counted in
// shared memory and flushed with one global atomicAdd per class and block;
// the wrapper checks that a block's 256 pixels never span two images.  The
// mask-only kernel takes any pixel count: the last block stages and
// computes only its valid pixels.
//
// Bound on the H100: memory — reading the bf16 features (134 MB at
// 256x256, batch 32, F = 32: 0.040 ms at 3.35 TB/s) against 0.54 GFLOP of
// f32 FMAs at C = 4; the kernel reads each feature byte once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tu {
int launch_final_tail(const __nv_bfloat16* feats, const float* w, const float* bias,
                      uint8_t* mask, int* hist, int n, int per_img, int C, bool with_hist,
                      cudaStream_t stream);
}

namespace {

constexpr int MAXC = 32;
constexpr int NTHR = 256;

template <int F, bool HIST>
__global__ void __launch_bounds__(NTHR)
final_argmax_kernel(const __nv_bfloat16* __restrict__ feats, const float* __restrict__ w,
                    const float* __restrict__ bias, uint8_t* __restrict__ mask,
                    int* __restrict__ hist, int n_pix, int per_img, int C) {
  constexpr int FW = F / 2;                    // words per pixel in device memory
  constexpr int RW = FW % 2 ? FW : FW + 1;     // in shared memory, rounded up to odd
  __shared__ uint32_t sx[NTHR * RW];
  __shared__ float sw[F * MAXC];
  __shared__ float sb[MAXC];
  __shared__ int sh[MAXC];
  const int tid = threadIdx.x;
  for (int i = tid; i < F * C; i += NTHR) sw[i] = w[i];
  if (tid < C) {
    sb[tid] = bias[tid];
    sh[tid] = 0;
  }

  const int pix0 = blockIdx.x * NTHR;
  const int npx = min(NTHR, n_pix - pix0);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(feats) + static_cast<size_t>(pix0) * FW;
  const int nw = npx * FW;  // words to stage
  const int nv = nw / 4;    // whole 16-byte vectors among them
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int v = tid; v < nv; v += NTHR) {
    const uint4 u = src4[v];
    const uint32_t part[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * v + k;
      sx[(i / FW) * RW + i % FW] = part[k];
    }
  }
  for (int i = 4 * nv + tid; i < nw; i += NTHR) sx[(i / FW) * RW + i % FW] = src[i];
  __syncthreads();

  if (tid < npx) {
    float xf[F];
    const uint32_t* row = sx + tid * RW;
#pragma unroll
    for (int j = 0; j < FW; ++j) {
      const uint32_t u = row[j];
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
      xf[2 * j] = f.x;
      xf[2 * j + 1] = f.y;
    }
    int cls = 0;
    float best = -__int_as_float(0x7f800000);  // -inf
    for (int c = 0; c < C; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) acc = fmaf(xf[f], sw[f * C + c], acc);
      acc += sb[c];
      if (acc > best) {
        best = acc;
        cls = c;
      }
    }
    mask[pix0 + tid] = static_cast<uint8_t>(cls);
    if (HIST) atomicAdd(&sh[cls], 1);
  }
  if (HIST) {
    __syncthreads();
    if (tid < C && sh[tid] != 0) atomicAdd(&hist[(pix0 / per_img) * C + tid], sh[tid]);
  }
}

template <int F, bool HIST>
int launch(const __nv_bfloat16* feats, const float* w, const float* bias, uint8_t* mask,
           int* hist, int n_pix, int per_img, int C, cudaStream_t stream) {
  const int blocks = (n_pix + NTHR - 1) / NTHR;
  final_argmax_kernel<F, HIST><<<blocks, NTHR, 0, stream>>>(feats, w, bias, mask, hist, n_pix,
                                                            per_img, C);
  return cudaGetLastError();
}

template <bool HIST>
int dispatch(const __nv_bfloat16* feats, const float* w, const float* bias, uint8_t* mask,
             int* hist, int n_pix, int per_img, int F, int C, cudaStream_t stream) {
  if (C < 1 || C > MAXC || n_pix < 1 || reinterpret_cast<uintptr_t>(feats) % 16 != 0)
    return cudaErrorInvalidValue;
  switch (F) {
    case 22: return launch<22, HIST>(feats, w, bias, mask, hist, n_pix, per_img, C, stream);
    case 32: return launch<32, HIST>(feats, w, bias, mask, hist, n_pix, per_img, C, stream);
    case 64:
      return tu::launch_final_tail(feats, w, bias, mask, hist, n_pix, per_img, C, HIST, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tu_final_argmax_hist(const __nv_bfloat16* feats, const float* w, const float* bias,
                                    uint8_t* mask, int* hist, int n_pix, int per_img, int F,
                                    int C, cudaStream_t stream) {
  if (per_img < 1 || per_img % NTHR != 0) return cudaErrorInvalidValue;
  return dispatch<true>(feats, w, bias, mask, hist, n_pix, per_img, F, C, stream);
}

extern "C" int tu_final_argmax(const __nv_bfloat16* feats, const float* w, const float* bias,
                               uint8_t* mask, int n_pix, int F, int C, cudaStream_t stream) {
  return dispatch<false>(feats, w, bias, mask, nullptr, n_pix, 1, F, C, stream);
}
