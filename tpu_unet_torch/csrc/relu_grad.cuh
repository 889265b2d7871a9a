// The ReLU's gradient as a pass of its own: g = d * [out > 0] over NHWC
// tensors of bf16 or float32, one thread a 16-byte slot (8 bf16 or 4
// float32 channels).  A VGG16 block without the pool (block 5,
// csrc/encoder_train.cu) and a UnetUp stage's conv2 (g2 of
// csrc/decoder_train.cu) run it before their dgrads, which the Hopper conv
// core reads by TMA and cannot mask.  It selects, so it is exact in either
// type.
//
// Bound on the H100: bytes (d and out read, g written: 3 values a value).
#pragma once

#include "sm90.cuh"

namespace tu {
namespace {

using sm90::from_f;
using sm90::to_f;

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(256)
relu_grad_kernel(const T* __restrict__ d, const T* __restrict__ out, T* __restrict__ g,
                 size_t n16) {
  constexpr int EL = 16 / static_cast<int>(sizeof(T));
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n16) return;
  const uint4 du = ld16(d + idx * EL), ou = ld16(out + idx * EL);
  __align__(16) T res[EL];
#pragma unroll
  for (int j = 0; j < EL; ++j)
    res[j] = to_f(reinterpret_cast<const T*>(&ou)[j]) > 0.f ? reinterpret_cast<const T*>(&du)[j]
                                                          : from_f<T>(0.f);
  *reinterpret_cast<uint4*>(g + idx * EL) = *reinterpret_cast<const uint4*>(res);
}

// g = d * [out > 0] over n16 16-byte slots (the tensors' bytes / 16)
template <typename T>
cudaError_t launch_relu_grad(const T* d, const T* out, T* g, size_t n16, cudaStream_t stream) {
  relu_grad_kernel<T><<<static_cast<unsigned>((n16 + 255) / 256), 256, 0, stream>>>(d, out, g,
                                                                                    n16);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tu
