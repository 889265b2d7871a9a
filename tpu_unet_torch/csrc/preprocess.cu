// normalize_images: uint8 images -> float32 or bf16 in [0, 1], as
// dtype(float32(u8) * float32(1 / 255)).
//
// Replaces tpu_unet/kernels/preprocess.py::normalize_images (the Pallas
// call at preprocess.py:39), whose kernel body (:22-23) widens u8 to f32,
// multiplies by the f32 constant 1.0 / 255.0 and casts to the compute
// dtype; the product is one IEEE multiply and the bf16 cast rounds to
// nearest even, so the kernel is bit-exact against both the TPU kernel and
// the plain PyTorch version.
//
// Elementwise over the flat (N * H * W * 3) array: a grid-stride loop in
// which each thread turns one 16-byte vector of uint8 into 16 outputs
// (four 16-byte float4 stores, or two of packed bf16); the elements past
// the last whole vector, or every element when a pointer is not 16-byte
// aligned, go one at a time.
//
// Bound on the H100: memory — 1 byte read and 4 (f32) or 2 (bf16) written
// per element: 0.98 MB for one 256x256 image to f32 (0.3 us at 3.35 TB/s,
// far below the launch latency), 31 MB for a batch of 32.
//
// What a call costs is its launch, not this body: on an H100 the device
// time is 1.4-3.9 us at one image and 9 / 20 us (bf16 / f32) at 32 x 256^2,
// within twice the bound plus a launch, while a call cost the host 17-27
// us when it built a torch.cuda.Stream, took a lock and checked its input
// in five steps.  So the design is the call's: the wrapper (kernels/preprocess.py)
// takes its input after one combined test, and kernels/_build.py::call
// reaches this entry resolved at load, with the raw handle of the current
// stream, building no Python object but the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHR = 256;
constexpr int MAX_BLOCKS = 4096;
// float32(1.0 / 255.0): the double constant rounded to nearest, as JAX
// converts the Python float of the TPU kernel
constexpr float INV255 = static_cast<float>(1.0 / 255.0);

__device__ __forceinline__ void put16(float* out, const float (&v)[16]) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void put16(__nv_bfloat16* out, const float (&v)[16]) {
  uint32_t p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    p[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(p[0], p[1], p[2], p[3]);
  o[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

__device__ __forceinline__ void put1(float* out, float v) { *out = v; }
__device__ __forceinline__ void put1(__nv_bfloat16* out, float v) { *out = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(NTHR)
normalize_kernel(const uint8_t* __restrict__ in, T* __restrict__ out, long long n, long long nv) {
  const long long stride = static_cast<long long>(gridDim.x) * NTHR;
  const long long gid = static_cast<long long>(blockIdx.x) * NTHR + threadIdx.x;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  for (long long v = gid; v < nv; v += stride) {
    const uint4 u = in4[v];
    const uint32_t word[4] = {u.x, u.y, u.z, u.w};
    float x[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      x[k] = static_cast<float>((word[k / 4] >> (8 * (k % 4))) & 0xffu) * INV255;
    put16(out + 16 * v, x);
  }
  for (long long i = 16 * nv + gid; i < n; i += stride)
    put1(out + i, static_cast<float>(in[i]) * INV255);
}

template <typename T>
int launch(const uint8_t* in, T* out, long long n, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long nv = aligned ? n / 16 : 0;
  const long long work = nv > 0 ? nv : n;
  const int blocks = static_cast<int>(
      work / NTHR + 1 < MAX_BLOCKS ? work / NTHR + 1 : MAX_BLOCKS);
  normalize_kernel<T><<<blocks, NTHR, 0, stream>>>(in, out, n, nv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tu_normalize_images(const uint8_t* in, void* out, long long n, int out_bf16,
                                   cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  if (out_bf16) return launch(in, static_cast<__nv_bfloat16*>(out), n, stream);
  return launch(in, static_cast<float*>(out), n, stream);
}
