// vgg_stem: VGG16 block 1 — conv1_1 (3 -> F) + ReLU, conv1_2 (F -> F) + ReLU,
// 2x2 max-pool — for the serving path and, keeping a1, for training.
//
// Replaces tpu_unet/kernels/stem.py::fused_vgg_stem_impl (the Pallas call
// at stem.py:220).  Like the TPU kernel, it reads the raw uint8 image and
// applies the exact bf16 /255 as conv1_1 gathers its operand, so no
// normalised image is stored, and it emits the skip and the pooled tensor
// from one epilogue.  Unlike it, conv1_1's output a1 goes through device
// memory.  Two launches on the Hopper kernels, per the host plan
// (kernels/sm90.py::stem_fwd_launches):
//   1. conv1_1 on a wgmma GEMM of its own (conv_image_kernel, record op
//      OP_FWD_IMAGE): a1 (pixels x F) = relu(im2col(img) (pixels x 64) *
//      W11^T + b11) with the 27 im2col columns (k = tap * 3 + c) padded to
//      64.  No TMA box takes the image (a pixel is 3 or 6 bytes, TMA
//      strides are multiples of 16), so a producer warpgroup gathers each
//      pixel's columns into a 128-byte-swizzled stage
//      (csrc/image_gather.cuh, shared with the stem backward's image GEMM,
//      csrc/encoder_train.cu), normalising a uint8 image there through a
//      256-entry table of the exact quotients in shared memory, a thread's
//      27 loads all issued before any is used (dividing each value as its
//      load arrived ran conv1_1 at 3.3 times its floor on an H100, this at
//      1.6 times); the consumer warpgroup multiplies the 128-pixel tile by
//      the block's 64 rows of W11, held in shared memory from the start
//      (8 KB), and writes bias + ReLU through a staged tile, 16 bytes a
//      thread.  Two blocks an SM, each walking its share of the 8 x 16
//      patches through a ring of 4 stages, so the gathers of one overlap
//      the other's stores;
//   2. conv1_2 on the Hopper conv core (csrc/conv3x3_sm90.cuh) over a1 with
//      bias + ReLU and the 2x2 max-pool in its epilogue (OP_FWD_POOL), at
//      the tile of conv_tile_m (256 x 64, persistent, where H % 16 == 0;
//      else 128 x 64), as block 2's second conv runs.
//
// Bound on the H100: operations (conv1_2 is 95% of them: 162 GFLOP at
// 512x512, batch 8, 0.164 ms at 989 TFLOP/s).  conv1_1 is bound by writing
// a1 (268 MB at 512x512, batch 8: 0.080 ms at 3.35 TB/s); its 8.6 GFLOP
// with K padded to 64 take 0.009 ms on the tensor cores.  The design's
// floor, with a1 stored and read back, is 0.88 GB of bytes (0.26 ms); a
// conv1_2 whose producer computes a1 into its stages would drop a1's round
// trip.  Shapes: H % 8, W % 16, F % 64 all 0.
#include "conv3x3_sm90.cuh"
#include "image_gather.cuh"

using bf16 = __nv_bfloat16;

namespace tu {
namespace sm90 {
namespace {

// conv1_1's GEMM: a ring of gathered 128-pixel tiles (128 rows of 64
// columns, 16 KB each), the block's 64 f x 64 columns of W11 (K-major and
// swizzled as a TMA weight box), the epilogue's bf16 tile, the uint8
// normalisation table (256 bf16)
struct ImageFwdSmem {
  static constexpr int STAGES = 4;
  static constexpr int W_OFF = STAGES * BOX_BYTES;
  static constexpr int LDC = 64 + 8;  // staging row (bf16)
  static constexpr int OUT_OFF = W_OFF + 64 * SLICE_C * 2;
  static constexpr int LUT_OFF = OUT_OFF + PATCH * LDC * 2;
  static constexpr int BAR_OFF = LUT_OFF + 256 * 2;
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;
};

// a1 (B, H, W, F): block (i, f tile j) takes output channels [64 j, 64 j
// + 64) of patches i, i + gridDim.x, ...  Threads 0-127 consume (wgmma
// m64n64k16 on the tile's two m64 halves, the epilogue), threads 128-255
// produce: thread 128 + r gathers pixel r of each patch (row r of the
// stage).  w: W11 packed (F, 64), K contiguous, columns 27-63 zero.
template <bool U8>
__global__ void __launch_bounds__(256, 2)
conv_image_kernel(const void* __restrict__ img, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ out, int B, int H, int W,
                  int F) {
  using S = ImageFwdSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* wt = smem + S::W_OFF;
  bf16* sc = reinterpret_cast<bf16*>(smem + S::OUT_OFF);
  bf16* lut = reinterpret_cast<bf16*>(smem + S::LUT_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * 64;
  const int tiles_w = W / PATCH_W, tiles_hw = (H / PATCH_H) * tiles_w;
  const int npatch = B * tiles_hw;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 128);   // the producers' stores
      mbar_init(&empty[s], 128);  // the consumers' reads
    }
    mbar_init_fence();
  }
  // W11's rows n0 .. n0 + 63: logical chunk j of row r at physical chunk
  // j ^ (r % 8), as a weight box of the conv core lands
  for (int i = tid; i < 64 * 8; i += 256) {
    const int r = i >> 3, j = i & 7;
    *reinterpret_cast<uint4*>(wt + r * 128 + ((j ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * SLICE_C + j * 8);
  }
  if (U8) fill_u8_lut(lut, tid);
  fence_proxy_async();
  __syncthreads();

  if (tid >= 128) {  // the producer warpgroup
    const int r = tid - 128, py = r >> 4, px = r & 15;
    int it = 0;
    for (int q = blockIdx.x; q < npatch; q += gridDim.x, ++it) {
      const int st = it % S::STAGES;
      if (it >= S::STAGES) mbar_wait(&empty[st], ((it / S::STAGES) - 1) & 1);
      const int b = q / tiles_hw, thw = q - b * tiles_hw;
      const int y0 = (thw / tiles_w) * PATCH_H, x0 = (thw % tiles_w) * PATCH_W;
      gather_image_row<U8>(img, lut, b, H, W, y0 + py, x0 + px, smem + st * BOX_BYTES, r);
      fence_proxy_async();
      mbar_arrive(&full[st]);
    }
    return;
  }

  const int lane = tid & 31;
  const uint64_t db = desc_sw128(wt, 16, 1024);
  int it = 0;
  for (int q = blockIdx.x; q < npatch; q += gridDim.x, ++it) {
    const int st = it % S::STAGES;
    mbar_wait(&full[st], (it / S::STAGES) & 1);
    const uint8_t* a = smem + st * BOX_BYTES;
    float acc[2][32];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[i][c] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // pixel rows 64 i .. 64 i + 63 of the tile
      const uint64_t da = desc_sw128(a + i * (64 * SLICE_C * 2), 16, 1024);
#pragma unroll
      for (int k = 0; k < SLICE_C / 16; ++k)  // 32 bytes of K a step
        wgmma<64, 0, 0>(acc[i], da + 2 * k, db + 2 * k, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i) fence_acc(acc[i]);
    mbar_arrive(&empty[st]);  // the stage is read: the producer may refill it

    const int b = q / tiles_hw, thw = q - b * tiles_hw;
    const int y0 = (thw / tiles_w) * PATCH_H, x0 = (thw % tiles_w) * PATCH_W;
    // bias + ReLU, staged as bf16 rows of the tile (the wgmma fragment:
    // warp w holds rows 16w .. 16w + 15 of each m64 half; lane: row lane / 4
    // and + 8, columns 2 (lane % 4) + {0, 1} of every 8-column group)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i * 64 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int c = 8 * g + 2 * (lane & 3);
        const float b0 = bias[n0 + c], b1 = bias[n0 + c + 1];
        *reinterpret_cast<__nv_bfloat162*>(&sc[r * S::LDC + c]) = __floats2bfloat162_rn(
            fmaxf(acc[i][4 * g] + b0, 0.f), fmaxf(acc[i][4 * g + 1] + b1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(&sc[(r + 8) * S::LDC + c]) = __floats2bfloat162_rn(
            fmaxf(acc[i][4 * g + 2] + b0, 0.f), fmaxf(acc[i][4 * g + 3] + b1, 0.f));
      }
    }
    bar_sync(1, 128);
    // the tile's 128 pixels x 8 chunks of 16 bytes, 8 a thread, coalesced
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = tid + j * 128, px = v >> 3, sub = v & 7;
      const size_t pix =
          (static_cast<size_t>(b) * H + y0 + px / PATCH_W) * W + x0 + px % PATCH_W;
      *reinterpret_cast<uint4*>(out + pix * F + n0 + sub * 8) =
          *reinterpret_cast<const uint4*>(&sc[px * S::LDC + sub * 8]);
    }
    bar_sync(1, 128);  // the staged tile is written out: the next may overwrite it
  }
}

// conv1_1 per its record (OP_FWD_IMAGE: tile 128 x 64, grid (blocks, F /
// 64)); w11 packed (F, 64).
inline cudaError_t launch_conv_image(const Launch& L, const void* img, bool u8, const bf16* w11,
                                     const float* b11, bf16* a1, int B, int H, int W, int F,
                                     cudaStream_t stream) {
  using S = ImageFwdSmem;
  const dim3 grid = L.grid();
  if (L.op() != OP_FWD_IMAGE || L.tile_m() != PATCH || L.tile_n() != 64 || grid.x == 0 ||
      static_cast<int>(grid.y) * 64 != F || grid.z != 1)
    return cudaErrorInvalidValue;
  auto kernel = u8 ? &conv_image_kernel<true> : &conv_image_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::DYN);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 256, S::DYN, stream>>>(img, w11, b11, a1, B, H, W, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sm90
}  // namespace tu

// img (B, H, W, 3) uint8 (is_u8) or bf16; w11 packed (F, 64) (K = tap * 3 +
// c, zero past 27), w12 packed (F, 9F); a1, skip (B, H, W, F), pooled (B,
// H/2, W/2, F); plan: conv1_1's record (OP_FWD_IMAGE), conv1_2's
// (OP_FWD_POOL over the one map a1).
extern "C" int tu_vgg_stem(const void* img, int is_u8, const bf16* w11, const float* b11,
                           const bf16* w12, const float* b12, bf16* a1, bf16* skip,
                           bf16* pooled, int B, int H, int W, int F, const int64_t* plan,
                           cudaStream_t stream) {
  namespace sm90 = tu::sm90;
  if (plan == nullptr) return cudaErrorInvalidValue;
  const sm90::Launch l1{plan}, l2{plan + sm90::PLAN_WORDS};
  const int64_t* m = l2.map(0);  // conv1_2's input map: a1 as (F, W, H, B)
  if (l2.op() != sm90::OP_FWD_POOL || l2.has_map(2) || m[1] != F || m[2] != W || m[3] != H ||
      m[4] != B)
    return cudaErrorInvalidValue;
  cudaError_t e = sm90::launch_conv_image(l1, img, is_u8 != 0, w11, b11, a1, B, H, W, F, stream);
  if (e != cudaSuccess) return e;
  return sm90::launch_conv_sm90(
      l2.w, a1, nullptr, w12, sm90::ConvArgs{b12, nullptr, skip, pooled, H, W, F, F}, stream);
}
