// argmax_mask: per-pixel index of the largest logit of (N, H, W, C) logits
// (bf16 or f32, C <= 32), written as int32 or uint8.
//
// Replaces tpu_unet/kernels/postprocess.py::fused_argmax_mask (the Pallas
// call at :56), whose body (:22-27) casts a (1024, C) row block to f32 and
// takes jnp.argmax over C.  Here too every comparison runs in f32 (bf16 ->
// f32 is exact), the first maximum wins (strict >), and a NaN counts as the
// maximum: the first NaN of a row wins, as jnp.argmax and torch.argmax
// return it.  The generic serving step writes the uint8 form directly.
//
// One thread per pixel.  A pixel's row is C * itemsize bytes; the thread
// reads it as vectors of the widest size (16, 8, 4 or 2 bytes) that divides
// both the row and the base pointer's alignment, so at C = 4 a thread issues
// one 16-byte (f32) or 8-byte (bf16) load and a warp reads 512 or 256
// contiguous bytes; at C = 21 (f32: 84 bytes, bf16: 42) it reads words or
// half-words and the L1 cache serves the rest of each line.
//
// Bound on the H100: memory — each logit is read once and one index written
// per pixel: 8x512^2x21 f32 -> uint8 is 178 MB (0.053 ms at 3.35 TB/s),
// 32x256^2x4 bf16 -> uint8 18.9 MB (0.0056 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHR = 256;
constexpr int MAXC = 32;

template <int BYTES> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VB, typename OutT>
__global__ void __launch_bounds__(NTHR)
argmax_kernel(const T* __restrict__ logits, OutT* __restrict__ out, long long n_pix, int C) {
  using V = typename Vec<VB>::T;
  constexpr int E = VB / static_cast<int>(sizeof(T));  // logits per vector
  const long long p = static_cast<long long>(blockIdx.x) * NTHR + threadIdx.x;
  if (p >= n_pix) return;
  const V* row = reinterpret_cast<const V*>(logits + p * C);
  const int nv = C / E;
  float best = -INFINITY;
  int arg = 0;
#pragma unroll 4
  for (int k = 0; k < nv; ++k) {
    const V v = row[k];
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float x = to_f32(e[j]);
      if (x > best || (isnan(x) && !isnan(best))) {
        best = x;
        arg = k * E + j;
      }
    }
  }
  out[p] = static_cast<OutT>(arg);
}

template <typename T, typename OutT>
int launch(const T* logits, OutT* out, long long n_pix, int C, cudaStream_t stream) {
  const int row = C * static_cast<int>(sizeof(T));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(logits);
  const unsigned blocks = static_cast<unsigned>((n_pix + NTHR - 1) / NTHR);
  auto fits = [&](int vb) { return row % vb == 0 && addr % vb == 0; };
  if (fits(16)) {
    argmax_kernel<T, 16, OutT><<<blocks, NTHR, 0, stream>>>(logits, out, n_pix, C);
  } else if (fits(8)) {
    argmax_kernel<T, 8, OutT><<<blocks, NTHR, 0, stream>>>(logits, out, n_pix, C);
  } else if (fits(4)) {
    argmax_kernel<T, 4, OutT><<<blocks, NTHR, 0, stream>>>(logits, out, n_pix, C);
  } else {
    if constexpr (sizeof(T) == 2) {
      argmax_kernel<T, 2, OutT><<<blocks, NTHR, 0, stream>>>(logits, out, n_pix, C);
    } else {
      return cudaErrorMisalignedAddress;  // an f32 row is always 4-byte aligned
    }
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch_out(const void* logits, void* out, long long n_pix, int C, int out_u8,
                 cudaStream_t stream) {
  const T* in = static_cast<const T*>(logits);
  if (out_u8) return launch(in, static_cast<uint8_t*>(out), n_pix, C, stream);
  return launch(in, static_cast<int32_t*>(out), n_pix, C, stream);
}

}  // namespace

extern "C" int tu_argmax_mask(const void* logits, void* out, long long n_pix, int C,
                              int in_bf16, int out_u8, cudaStream_t stream) {
  if (n_pix < 1 || C < 1 || C > MAXC) return cudaErrorInvalidValue;
  if (in_bf16) return dispatch_out<__nv_bfloat16>(logits, out, n_pix, C, out_u8, stream);
  return dispatch_out<float>(logits, out, n_pix, C, out_u8, stream);
}
