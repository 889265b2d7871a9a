// The ReLU's gradient as a pass of its own: g = d * [out > 0] over NHWC
// bf16 tensors, one thread a 16-byte slot of 8 channels.  A VGG16 block
// without the pool (block 5, csrc/encoder_train.cu) and a UnetUp stage's
// conv2 (g2 of csrc/decoder_train.cu) run it before their dgrads, which
// the Hopper conv core reads by TMA and cannot mask.
//
// Bound on the H100: bytes (d and out read, g written: 6 bytes a value).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tu {
namespace {

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__global__ void __launch_bounds__(256)
relu_grad_kernel(const __nv_bfloat16* __restrict__ d, const __nv_bfloat16* __restrict__ out,
                 __nv_bfloat16* __restrict__ g, size_t n8) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n8) return;
  const uint4 du = ld16(d + idx * 8), ou = ld16(out + idx * 8);
  __align__(16) __nv_bfloat16 res[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    res[j] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&ou)[j]) > 0.f
                 ? reinterpret_cast<const __nv_bfloat16*>(&du)[j]
                 : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(g + idx * 8) = *reinterpret_cast<const uint4*>(res);
}

// g = d * [out > 0] over n8 * 8 values (the tensors' sizes, % 8 == 0)
inline cudaError_t launch_relu_grad(const __nv_bfloat16* d, const __nv_bfloat16* out,
                                    __nv_bfloat16* g, size_t n8, cudaStream_t stream) {
  relu_grad_kernel<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, stream>>>(d, out, g, n8);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tu
