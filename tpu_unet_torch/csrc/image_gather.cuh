// The 3-channel image's im2col rows for the Hopper GEMMs of the VGG16
// stem's conv1_1: its forward (csrc/stem.cu) and its weight gradient
// (csrc/encoder_train.cu::wgrad_image_kernel).  An image pixel is 3 bytes
// (uint8) or 6 (bf16) and TMA's strides are multiples of 16 bytes, so no
// TMA box takes the image: a producer thread gathers one pixel's 3 x 3
// neighbourhood and stores it as TMA stores a row of a 128-byte-swizzled
// box, and wgmma reads the tile with the descriptors of such a box.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace tu {
namespace sm90 {
namespace {

constexpr int IMG_K = 27;  // the image's im2col columns: 9 taps x 3 channels

// Row r of a tile of 128-byte rows at `tile` (1024-byte aligned): the 64
// im2col columns of image pixel (b, y, x) of img (B, H, W, 3), column k =
// tap * 3 + c holding channel c of the pixel at (y + ky - 1, x + kx - 1)
// (tap = 3 ky + kx), zero outside the image (SAME padding) and past column
// 27; logical 16-byte chunk j of the row at physical chunk j ^ (r % 8), as
// TMA's CU_TENSOR_MAP_SWIZZLE_128B lays it out.  U8: the raw uint8 image,
// each value v normalised through lut[v] = bf16(bf16(v) / bf16(255))
// (core/precision.py::normalize_u8; fill_u8_lut); else the bf16 image as
// it is.  Every load is issued before any value is used, so a thread waits
// on its 27 loads once.
template <bool U8>
__device__ __forceinline__ void gather_image_row(const void* img, const __nv_bfloat16* lut,
                                                 int b, int H, int W, int y, int x,
                                                 uint8_t* tile, int r) {
  using bf16 = __nv_bfloat16;
  using raw_t = typename std::conditional<U8, uint8_t, unsigned short>::type;
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
  __align__(16) bf16 v[64];
#pragma unroll
  for (int k = 0; k < IMG_K; ++k) {
    if constexpr (U8)
      v[k] = lut[raw[k]];  // lut[0] == 0: the padding
    else
      v[k] = __ushort_as_bfloat16(raw[k]);
  }
#pragma unroll
  for (int k = IMG_K; k < 64; ++k) v[k] = __float2bfloat16_rn(0.f);
  uint8_t* row = tile + r * 128;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<uint4*>(row + ((j ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(&v[8 * j]);
}

// lut[v] = bf16(bf16(v) / bf16(255)) for v in 0..255 (bf16(v) and bf16(255)
// are exact; the quotient rounded once from float32, as the plain
// version's bf16 division), by threads 0-255 of the block
__device__ __forceinline__ void fill_u8_lut(__nv_bfloat16* lut, int tid) {
  if (tid < 256) lut[tid] = __float2bfloat16_rn(__fdiv_rn(static_cast<float>(tid), 255.f));
}

}  // namespace
}  // namespace sm90
}  // namespace tu
