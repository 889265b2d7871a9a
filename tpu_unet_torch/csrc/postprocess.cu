// The serving tails' C entries: final 1x1 conv (F -> C), per-pixel argmax
// and uint8 mask, with (tu_final_argmax_hist) or without (tu_final_argmax)
// the per-image class histogram; the logits are never stored.
//
// Replaces three functions of tpu_unet/kernels/postprocess.py:
//   - fused_final_argmax_hist_paired (the Pallas call at :244), the
//     canonical UNets' tail, F = 64;
//   - fused_final_argmax_hist (:154), the natural-layout tail of the
//     TraditionalUnet family, F = 32 (traditional) and 22 (traditional22);
//   - fused_final_argmax (:92), the mask-only tail that :148-152 takes when
//     an image's pixel count is not a multiple of the row block.
// Every width runs one kernel, csrc/tail_sm90.cu (the products on wgmma
// behind a ring of TMA loads at F = 64, of 1-D bulk copies at F = 22 and
// 32); its note gives the design and the bound.  Here: the entries' checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tu {
int launch_final_tail(const __nv_bfloat16* feats, const float* w, const float* bias,
                      uint8_t* mask, int* hist, int n, int per_img, int F, int C, bool with_hist,
                      cudaStream_t stream);
}

namespace {
constexpr int HIST_BLOCK = 256;  // a histogram image's pixels are a multiple of this
}

extern "C" int tu_final_argmax_hist(const __nv_bfloat16* feats, const float* w, const float* bias,
                                    uint8_t* mask, int* hist, int n_pix, int per_img, int F,
                                    int C, cudaStream_t stream) {
  if (per_img < 1 || per_img % HIST_BLOCK != 0) return cudaErrorInvalidValue;
  return tu::launch_final_tail(feats, w, bias, mask, hist, n_pix, per_img, F, C, true, stream);
}

extern "C" int tu_final_argmax(const __nv_bfloat16* feats, const float* w, const float* bias,
                               uint8_t* mask, int n_pix, int F, int C, cudaStream_t stream) {
  return tu::launch_final_tail(feats, w, bias, mask, nullptr, n_pix, 1, F, C, false, stream);
}
