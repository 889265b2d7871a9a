// The 3-channel image's im2col rows for the Hopper GEMMs of the VGG16
// stem's conv1_1: its forward (csrc/stem.cu) and its weight gradient
// (csrc/encoder_train.cu::wgrad_image_kernel).  An image pixel is 3 bytes
// (uint8) or 6 (bf16) and TMA's strides are multiples of 16 bytes, so no
// TMA box takes the image: a producer thread gathers one pixel's 3 x 3
// neighbourhood and stores it as TMA stores a row of a 128-byte-swizzled
// box, and wgmma reads the tile with the descriptors of such a box (the
// float32 path: 32 float32 columns a row, rounded to TF32).
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace tu {
namespace sm90 {
namespace {

constexpr int IMG_K = 27;  // the image's im2col columns: 9 taps x 3 channels

// Row r of a tile of 128-byte rows at `tile` (1024-byte aligned): the
// im2col columns of image pixel (b, y, x) of img (B, H, W, 3) in T (64
// bf16 or 32 float32 columns), column k = tap * 3 + c holding channel c of
// the pixel at (y + ky - 1, x + kx - 1) (tap = 3 ky + kx), zero outside the
// image (SAME padding) and past column 27; logical 16-byte chunk j of the
// row at physical chunk j ^ (r % 8), as TMA's CU_TENSOR_MAP_SWIZZLE_128B
// lays it out.  U8: the raw uint8 image, each value v normalised through
// lut (fill_u8_lut); else the image in T as it is.  float32 values are
// rounded to TF32 (to_tf32) as they are stored: the GEMMs' products are
// TF32.  Every load is issued before any value is used, so a thread waits
// on its 27 loads once.
template <bool U8, typename T>
__device__ __forceinline__ void gather_image_row(const void* img, const T* lut, int b, int H,
                                                 int W, int y, int x, uint8_t* tile, int r) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int N = 128 / static_cast<int>(sizeof(T));  // columns of a row
  using bits_t = typename std::conditional<F32, float, unsigned short>::type;
  using raw_t = typename std::conditional<U8, uint8_t, bits_t>::type;
  const raw_t* src = static_cast<const raw_t*>(img);
  raw_t raw[IMG_K];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int iy = y + tap / 3 - 1, ix = x + tap % 3 - 1;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const size_t o = in ? ((static_cast<size_t>(b) * H + iy) * W + ix) * 3 : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) raw[tap * 3 + c] = in ? src[o + c] : raw_t(0);
  }
  __align__(16) T v[N];
#pragma unroll
  for (int k = 0; k < IMG_K; ++k) {
    T e;
    if constexpr (U8)
      e = lut[raw[k]];  // lut[0] == 0: the padding
    else if constexpr (F32)
      e = raw[k];
    else
      e = __ushort_as_bfloat16(raw[k]);
    if constexpr (F32) e = __uint_as_float(to_tf32(e));
    v[k] = e;
  }
#pragma unroll
  for (int k = IMG_K; k < N; ++k) v[k] = from_f<T>(0.f);
  uint8_t* row = tile + r * 128;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<uint4*>(row + ((j ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(&v[j * (N / 8)]);
}

// lut[v] = T(f32(v) / 255) for v in 0..255, by threads 0-255 of the block:
// the quotient rounded once from float32, which is bf16(bf16(v) / bf16(255))
// (bf16(v) and bf16(255) are exact), the plain version's bf16 division, and
// in float32 the float32 step's u8.astype(f32) / 255 exactly
template <typename T>
__device__ __forceinline__ void fill_u8_lut(T* lut, int tid) {
  if (tid < 256) lut[tid] = from_f<T>(__fdiv_rn(static_cast<float>(tid), 255.f));
}

}  // namespace
}  // namespace sm90
}  // namespace tu
