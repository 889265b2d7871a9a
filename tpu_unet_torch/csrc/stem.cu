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
// trip.  The float32 path's instantiations (T = float: the weights'
// dtype) gather 32 float32 columns a pixel, each rounded to TF32 as it is
// stored (a uint8 image through the table f32(v) / 255, the float32
// step's u8.astype(f32) / 255 exactly; a float32 image as it is), multiply
// by W11 packed in float32 and rounded to TF32 on wgmma m64n64k8 .tf32,
// and write float32 a1; conv1_2 runs on the conv core's float32
// instantiation.  Shapes: H % 8, W % 16, F % 64 all 0.
#include "conv3x3_sm90.cuh"
#include "image_gather.cuh"

using bf16 = __nv_bfloat16;

namespace tu {
namespace sm90 {
namespace {

// conv1_1's GEMM: a ring of gathered 128-pixel tiles (128 rows of 128
// bytes: 64 bf16 or 32 float32 columns, 16 KB each), the block's 64 f x
// one 128-byte K slice of W11 (K-major and swizzled as a TMA weight box),
// the epilogue's tile in T, the uint8 normalisation table (256 T)
template <typename T>
struct ImageFwdSmem {
  static constexpr int STAGES = 4;
  static constexpr int W_OFF = STAGES * BOX_BYTES;
  static constexpr int LDC = 64 + 16 / static_cast<int>(sizeof(T));  // staging row (T)
  static constexpr int OUT_OFF = W_OFF + 64 * 128;
  static constexpr int LUT_OFF = OUT_OFF + PATCH * LDC * static_cast<int>(sizeof(T));
  static constexpr int BAR_OFF = LUT_OFF + 256 * static_cast<int>(sizeof(T));
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;
};

// a1 (B, H, W, F): block (i, f tile j) takes output channels [64 j, 64 j
// + 64) of patches i, i + gridDim.x, ...  Threads 0-127 consume (wgmma
// m64n64, k16 bf16 or k8 TF32, on the tile's two m64 halves, the
// epilogue), threads 128-255 produce: thread 128 + r gathers pixel r of
// each patch (row r of the stage).  w: W11 packed (F, 128 / sizeof(T)), K
// contiguous, columns 27 on zero (float32: rounded to TF32 on the host).
template <typename T, bool U8>
__global__ void __launch_bounds__(256, 2)
conv_image_kernel(const void* __restrict__ img, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int B, int H, int W,
                  int F) {
  using S = ImageFwdSmem<T>;
  constexpr int SL = slice_of<T>(), EL = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* wt = smem + S::W_OFF;
  T* sc = reinterpret_cast<T*>(smem + S::OUT_OFF);
  T* lut = reinterpret_cast<T*>(smem + S::LUT_OFF);
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
        *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * SL + j * EL);
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
      const uint64_t da = desc_sw128(a + i * (64 * 128), 16, 1024);
#pragma unroll
      for (int k = 0; k < 4; ++k)  // 32 bytes of K a step
        wgmma_k32<T, 64>(acc[i], da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i) fence_acc(acc[i]);
    mbar_arrive(&empty[st]);  // the stage is read: the producer may refill it

    const int b = q / tiles_hw, thw = q - b * tiles_hw;
    const int y0 = (thw / tiles_w) * PATCH_H, x0 = (thw % tiles_w) * PATCH_W;
    // bias + ReLU, staged as T rows of the tile (the wgmma fragment: warp w
    // holds rows 16w .. 16w + 15 of each m64 half; lane: row lane / 4 and +
    // 8, columns 2 (lane % 4) + {0, 1} of every 8-column group)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i * 64 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int c = 8 * g + 2 * (lane & 3);
        const float b0 = bias[n0 + c], b1 = bias[n0 + c + 1];
        const float v0 = fmaxf(acc[i][4 * g] + b0, 0.f), v1 = fmaxf(acc[i][4 * g + 1] + b1, 0.f);
        const float v2 = fmaxf(acc[i][4 * g + 2] + b0, 0.f),
                    v3 = fmaxf(acc[i][4 * g + 3] + b1, 0.f);
        if constexpr (is_f32<T>()) {
          *reinterpret_cast<float2*>(&sc[r * S::LDC + c]) = make_float2(v0, v1);
          *reinterpret_cast<float2*>(&sc[(r + 8) * S::LDC + c]) = make_float2(v2, v3);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(&sc[r * S::LDC + c]) = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(&sc[(r + 8) * S::LDC + c]) =
              __floats2bfloat162_rn(v2, v3);
        }
      }
    }
    bar_sync(1, 128);
    // the tile's 128 pixels x CH chunks of 16 bytes, CH a thread, coalesced
    constexpr int CH = 64 / EL;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int v = tid + j * 128, px = v / CH, sub = v % CH;
      const size_t pix =
          (static_cast<size_t>(b) * H + y0 + px / PATCH_W) * W + x0 + px % PATCH_W;
      *reinterpret_cast<uint4*>(out + pix * F + n0 + sub * EL) =
          *reinterpret_cast<const uint4*>(&sc[px * S::LDC + sub * EL]);
    }
    bar_sync(1, 128);  // the staged tile is written out: the next may overwrite it
  }
}

// conv1_1 per its record (OP_FWD_IMAGE: tile 128 x 64, grid (blocks, F /
// 64), the element type T); w11 packed (F, 128 / sizeof(T)).
template <typename T>
cudaError_t launch_conv_image(const Launch& L, const void* img, bool u8, const T* w11,
                              const float* b11, T* a1, int B, int H, int W, int F,
                              cudaStream_t stream) {
  using S = ImageFwdSmem<T>;
  const dim3 grid = L.grid();
  if (L.op() != OP_FWD_IMAGE || L.f32() != is_f32<T>() || L.tile_m() != PATCH ||
      L.tile_n() != 64 || grid.x == 0 || static_cast<int>(grid.y) * 64 != F || grid.z != 1)
    return cudaErrorInvalidValue;
  auto kernel = u8 ? &conv_image_kernel<T, true> : &conv_image_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::DYN);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 256, S::DYN, stream>>>(img, w11, b11, a1, B, H, W, F);
  return cudaGetLastError();
}

// the C entry's work in the element type T, from untyped pointers
template <typename T>
int stem_fwd(const void* img, bool u8, const void* w11, const float* b11, const void* w12,
             const float* b12, void* a1, void* skip, void* pooled, int B, int H, int W, int F,
             const int64_t* plan, cudaStream_t stream) {
  const Launch l1{plan}, l2{plan + PLAN_WORDS};
  const int64_t* m = l2.map(0);  // conv1_2's input map: a1 as (F, W, H, B)
  if (l2.op() != OP_FWD_POOL || l2.has_map(2) || m[1] != F || m[2] != W || m[3] != H ||
      m[4] != B)
    return cudaErrorInvalidValue;
  T* ta1 = static_cast<T*>(a1);
  cudaError_t e = launch_conv_image<T>(l1, img, u8, static_cast<const T*>(w11), b11, ta1, B, H,
                                       W, F, stream);
  if (e != cudaSuccess) return e;
  return launch_conv_sm90<T>(
      l2.w, ta1, nullptr, static_cast<const T*>(w12),
      ConvArgsT<T>{b12, nullptr, static_cast<T*>(skip), static_cast<T*>(pooled), H, W, F, F},
      stream);
}

}  // namespace
}  // namespace sm90
}  // namespace tu

// img (B, H, W, 3) uint8 (is_u8) or of the element type (bf16, or float32
// with f32); w11 packed (F, 64) bf16 / (F, 32) float32 (K = tap * 3 + c,
// zero past 27), w12 packed (F, 9F), a1, skip (B, H, W, F), pooled (B, H/2,
// W/2, F), all of the element type; plan: conv1_1's record (OP_FWD_IMAGE),
// conv1_2's (OP_FWD_POOL over the one map a1), both naming that type.
extern "C" int tu_vgg_stem(const void* img, int is_u8, const void* w11, const float* b11,
                           const void* w12, const float* b12, void* a1, void* skip, void* pooled,
                           int B, int H, int W, int F, int f32, const int64_t* plan,
                           cudaStream_t stream) {
  namespace sm90 = tu::sm90;
  if (plan == nullptr) return cudaErrorInvalidValue;
  return (f32 ? sm90::stem_fwd<float> : sm90::stem_fwd<bf16>)(
      img, is_u8 != 0, w11, b11, w12, b12, a1, skip, pooled, B, H, W, F, plan, stream);
}
