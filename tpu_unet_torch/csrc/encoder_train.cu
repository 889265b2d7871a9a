// vgg_block_bwd: the backward of one VGG16 encoder stage in training — the
// stem (conv1_1 3 -> 64, conv1_2, pool) or a block of 2 or 3 chained 3x3
// conv + ReLU with an optional trailing 2x2 max-pool:
//   g_n   = (dskip + unpool(dpool)) * [out > 0]       (pool and last ReLU)
//   g_i-1 = conv3x3(g_i, flipT(w_i)) * [a_i-1 > 0]    (dgrad, ReLU of a_i-1)
//   dx    = conv3x3(g_0, flipT(w_0))                  (blocks only)
//   dk_i  = sum_p g_i[p] (x) im2col(a_i-1)[p],  db_i = sum_p g_i[p]  (float32)
// with a_-1 = x, a_n-1 = out and SAME padding.  unpool routes each pooled
// gradient to the first maximum of its 2x2 window in row-major order, as
// XLA's select-and-scatter does.
//
// Replaces the one-pass Pallas backwards of the training encoder:
// tpu_unet/kernels/stem_train.py::fused_vgg_stem_bwd_impl (the Pallas call
// at stem_train.py:245, #20), encoder_train.py::fused_vgg_block2_bwd_impl
// (:329, #22) and encoder3_train.py::fused_vgg_block3_bwd_impl (:349, #24).
// The TPU kernels keep each row tile's chain in VMEM, recompute the pool
// routing and accumulate the paired weight gradients in VMEM.  Here the
// chain goes through device memory in natural layout:
//   1. pool_relu_grad: one thread owns a pooled pixel's 2x2 window and 8
//      channels (16-byte loads), picks the first maximum per channel, adds
//      the pooled gradient to the skip's there (one bf16 rounding, as a bf16
//      add) and applies the ReLU mask; without the pool, the mask only
//      (csrc/relu_grad.cuh);
//   2. per conv, last first: the weight gradient through a GEMM over the
//      pixels, then the dgrad through a conv core with the ReLU mask of its
//      input in the epilogue (conv 0 of a block: the plain store to dx).
// Two gradient buffers alternate; the weight-gradient work area is reused
// from conv to conv (one stream orders them).  No atomics, so the result
// is bit-identical run to run.
//
// Step 2 runs on the Hopper kernels: the weight gradient on
// csrc/wgrad_sm90.cuh (bf16: MN-major wgmma operands straight from TMA
// boxes of g and the input) and the dgrad on csrc/conv3x3_sm90.cuh (OP_DGRAD_MASK;
// a block's conv 0 OP_DGRAD_SPLIT with every channel to dx), per the host
// plan's launch records (kernels/sm90.py::block_bwd_launches and, for the
// stem, stem_bwd_launches; the dgrads at the 256-pixel tile where the N
// tile is at most 128 wide and H % 16 == 0).
//
// The stem's conv1_1 weight gradient over the 3-channel image has a GEMM
// of its own here (wgrad_image_kernel): an image pixel is 6 bytes and
// TMA's strides are multiples of 16, so no TMA box takes the image.  The
// GEMM is 2% of the stem's operations and bound by reading g0 once (8 x
// 512^2 x 64 bf16: 0.080 ms at 3.35 TB/s).  A's G^T boxes come by TMA as
// wgrad_sm90.cuh takes them; B's 27 im2col columns (k = tap * 3 + c,
// padded to 64 with zeros) are gathered by the producer warpgroup, a
// thread a pixel of the 8 x 16 patch, and stored in the layout of a
// 128-byte-swizzled TMA box (csrc/image_gather.cuh, shared with the
// stem's forward), so one consumer warpgroup reads both with
// wgrad_sm90.cuh's descriptors (64 f x 64 columns).  Two blocks an SM,
// split over the patches, each a ring of 3 stages: a producer thread waits
// on its pixel's loads stage by stage, so the second block's producer
// gathers while the first's waits.  The stem computes no image gradient,
// as JAX's does not.
//
// The float32 path (T = float, the stage's dtype) runs the same chain:
// the pool / ReLU pass in float32 (the skip's and the pooled gradient's sum
// one float32 add), the weight gradients on the float32 GEMM of
// csrc/wgrad_sm90.cuh (TF32 wgmma, G restaged K-major), the blocks' dgrads
// on the conv core's float32 instantiation, the stem's masked dgrad on the
// halo mainloop (csrc/conv3x3_halo_sm90.cuh: one TMA halo box a 32-channel
// slice serves all nine taps, the gradient rounded to TF32 in place), and
// the image GEMM on wgrad_image_f32_kernel.  Each dgrad runs on the
// mainloop its record names (word 9; kernels/sm90.py::stem_bwd_launches,
// block_bwd_launches), and each mainloop refuses the other's records.
//
// Bound on the H100: operations — per conv a dgrad and a weight gradient
// of 2 * 9 * P * Cin * Cout each (the stem at 512x512, batch 8: 0.33 ms at
// 989 TFLOP/s bf16; block 2 0.469 ms; blocks 3-5 0.24-0.78 ms).
// Shapes: H % 8, W % 16, widths % 64 (the image's 3 channels apart).
#include "conv3x3_halo_sm90.cuh"
#include "image_gather.cuh"
#include "relu_grad.cuh"
#include "wgrad_sm90.cuh"

namespace tu {
namespace {

using bf16 = __nv_bfloat16;

// pooled: one thread a (b, py, px, 16 bytes of channels) slot of dpool (B,
// H/2, W/2, C): 8 bf16 channels, or 4 float32
template <typename T>
__global__ void __launch_bounds__(256)
pool_relu_grad_kernel(const T* __restrict__ dskip, const T* __restrict__ dpool,
                      const T* __restrict__ out, T* __restrict__ g, int B, int H, int W, int C) {
  constexpr int EL = 16 / static_cast<int>(sizeof(T));
  const int cg = C / EL, Hp = H / 2, Wp = W / 2;
  const size_t n = static_cast<size_t>(B) * Hp * Wp * cg;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c = static_cast<int>(idx % cg) * EL;
  size_t r = idx / cg;
  const int px = static_cast<int>(r % Wp);
  r /= Wp;
  const int py = static_cast<int>(r % Hp);
  const int b = static_cast<int>(r / Hp);
  size_t o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = ((static_cast<size_t>(b) * H + 2 * py + (q >> 1)) * W + 2 * px + (q & 1)) * C + c;
  const uint4 pu = ld16(dpool + ((static_cast<size_t>(b) * Hp + py) * Wp + px) * C + c);
  const T* pv = reinterpret_cast<const T*>(&pu);
  uint4 ou[4], su[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ou[q] = ld16(out + o[q]);
    su[q] = ld16(dskip + o[q]);
  }
  __align__(16) T res[4][EL];
#pragma unroll
  for (int j = 0; j < EL; ++j) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = to_f(reinterpret_cast<const T*>(&ou[q])[j]);
    int first = 0;
#pragma unroll
    for (int q = 1; q < 4; ++q)
      if (v[q] > v[first]) first = q;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const T s = reinterpret_cast<const T*>(&su[q])[j];
      // one rounding to T of the sum, as the plain version's add in T
      const T t = q == first ? from_f<T>(to_f(s) + to_f(pv[j])) : s;
      res[q][j] = v[q] > 0.f ? t : from_f<T>(0.f);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) *reinterpret_cast<uint4*>(g + o[q]) = *reinterpret_cast<const uint4*>(res[q]);
}

}  // namespace

namespace sm90 {
namespace {

// two blocks an SM, so that one's producer gathers while the other's waits
// on its loads
struct WgradImageSmem {
  static constexpr int STAGE = 2 * BOX_BYTES;            // a G box and the gathered im2col box
  static constexpr int STAGES = RING_BYTES / 2 / STAGE;  // 3
  static constexpr int SB_OFF = STAGES * STAGE;      // bias partials, 8 floats a consumer
  static constexpr int BAR_OFF = SB_OFF + 128 * 8 * 4;
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;
};

// The producer warpgroup of both image GEMMs: for each of the block's n_it
// patches from q_begin, thread pt = 0 loads the G boxes of the block's 64 f
// (64 / SL boxes, SL = slice_of<T>() f each) into stage it % STAGES (of
// STAGE bytes), and thread pt gathers row pt (a pixel's 27 columns) of the
// im2col box after them.
template <typename T, int STAGES, int STAGE>
__device__ __forceinline__ void wgrad_image_produce(uint8_t* smem, uint64_t* full,
                                                    uint64_t* empty, const CUtensorMap* gmap,
                                                    const T* img, const WgradArgs& p,
                                                    int q_begin, int n_it, int f0, int pt) {
  constexpr int SL = slice_of<T>(), NG = 64 / SL;
  const int py = pt >> 4, px = pt & 15;  // row pt of the patch's boxes
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
    const int q = q_begin + it, b = q / tiles_hw, thw = q - b * tiles_hw;
    const int y0 = (thw / tiles_w) * PATCH_H, x0 = (thw % tiles_w) * PATCH_W;
    uint8_t* base = smem + st * STAGE;
    if (pt == 0) {
      mbar_expect_tx(&full[st], NG * BOX_BYTES);
      for (int w = 0; w < NG; ++w)
        tma_load_4d(base + w * BOX_BYTES, gmap, &full[st], f0 + SL * w, x0, y0, b);
    }
    gather_image_row<false, T>(img, nullptr, b, p.H, p.W, y0 + py, x0 + px,
                               base + NG * BOX_BYTES, pt);
    fence_proxy_async();
    mbar_arrive(&full[st]);
  }
}

// part (nsplit, F, 64) and bpart (nsplit, F) float32: block (0, f tile,
// split s) sums G^T (64 f) x im2col(img) (64 columns) over its contiguous
// range of 8 x 16 pixel patches.  Threads 0-127 consume (wgmma m64n64k16,
// the bias sums from the G box), threads 128-255 produce: the first issues
// the G box's TMA load, and each gathers one pixel's 27 columns.
__global__ void __launch_bounds__(256, 2)
wgrad_image_kernel(const __grid_constant__ CUtensorMap gmap, const bf16* __restrict__ img,
                   WgradArgs p) {
  using S = WgradImageSmem;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x;
  const int f0 = blockIdx.y * 64, s = blockIdx.z, ns = gridDim.z;
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  const long long npatch = static_cast<long long>(p.B) * tiles_hw;
  const int q_begin = static_cast<int>(s * npatch / ns);
  const int n_it = static_cast<int>((s + 1) * npatch / ns) - q_begin;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], 129);  // 128 producers' stores, and the G box's bytes
      mbar_init(&empty[i], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warpgroup
    wgrad_image_produce<bf16, S::STAGES, S::STAGE>(smem, full, empty, &gmap, img, p, q_begin,
                                                   n_it, f0, tid - 128);
    return;
  }

  const int lane = tid & 31;
  const bool bias = p.bpart != nullptr;
  float acc[32], bacc[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) bacc[j] = 0.f;
  // the bias sums: thread tid reads logical 16-byte chunk tid & 7 (8 f) of
  // pixel rows tid / 8 + 16 i, found at physical chunk (tid & 7) ^ (row & 7)
  const int bchunk = ((tid & 7) ^ ((tid >> 3) & 7)) * 16;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S::STAGES;
    mbar_wait(&full[st], (it / S::STAGES) & 1);
    const uint8_t* base = smem + st * S::STAGE;
    const uint64_t da = desc_sw128(base, BOX_BYTES, 1024);
    const uint64_t db = desc_sw128(base + BOX_BYTES, BOX_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < PATCH / 16; ++k)  // 16 pixel rows (2048 bytes) a step
      wgmma<64, 1, 1>(acc, da + 128 * k, db + 128 * k, 1);
    wgmma_commit();
    if (bias) {
      const uint8_t* g = base + (tid >> 3) * 128 + bchunk;
#pragma unroll
      for (int i = 0; i < PATCH / 16; ++i) {
        const uint4 u = *reinterpret_cast<const uint4*>(g + i * 16 * 128);
        const bf16* gv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) bacc[j] += __bfloat162float(gv[j]);
      }
    }
    wgmma_wait<1>();  // the previous step's products are done: release its stage
    if (it > 0) mbar_arrive(&empty[(it - 1) % S::STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  float* out = p.part + static_cast<size_t>(s) * p.F * 64;
  const int f = f0 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 8 * i + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(f) * 64 + k) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(f + 8) * 64 + k) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  if (bias) {  // the 16 threads of each chunk, added in thread order
    float* sb = reinterpret_cast<float*>(smem + S::SB_OFF);
#pragma unroll
    for (int j = 0; j < 8; ++j) sb[tid * 8 + j] = bacc[j];
    bar_sync(1, 128);
    if (tid < 64) {
      const int chunk = tid >> 3, j = tid & 7;
      float sum = 0.f;
      for (int rr = 0; rr < 16; ++rr) sum += sb[(rr * 8 + chunk) * 8 + j];
      p.bpart[static_cast<size_t>(s) * p.F + f0 + tid] = sum;
    }
  }
}

// dk (F, 3, 3, 3) from part (nsplit, F, kp) (kp = 64 bf16, 32 float32
// columns): column k = tap * 3 + c to dk[f, c, tap], the splits added in
// order; db (F) likewise from bpart.  A block an f, a thread a column
// (thread 27 the bias).
__global__ void __launch_bounds__(32)
wgrad_image_reduce_kernel(const float* __restrict__ part, const float* __restrict__ bpart,
                          float* __restrict__ dk, float* __restrict__ db, int F, int nsplit,
                          int kp) {
  const int f = blockIdx.x, k = threadIdx.x;
  float sum = 0.f;
  if (k < IMG_K) {
    for (int i = 0; i < nsplit; ++i) sum += part[(static_cast<size_t>(i) * F + f) * kp + k];
    dk[(f * 3 + k % 3) * 9 + k / 3] = sum;
  } else if (k == IMG_K) {
    for (int i = 0; i < nsplit; ++i) sum += bpart[static_cast<size_t>(i) * F + f];
    db[f] = sum;
  }
}

// ---- the float32 image GEMM on mma.sync TF32 -------------------------------
//
// Fragment order.  Thread (g = lane / 4, t = lane % 4) loads, for pixel
// rows t and t + 4 of a k8 step, one 16-byte chunk of its warp's G box and
// one of the gathered box: logical chunk c = PERM[g] (4 consecutive f, 4
// consecutive columns).  Its four f are the rows (tile i, row g + 8 h) of
// its m16 tiles, f = 4 PERM[g] + 2 i + h, and its four columns are column
// g of its n8 tiles j, col = 4 PERM[g] + j; an accumulator's column 2t + e
// is col 4 PERM[2t + e] + j.  PERM = 0 4 1 5 2 6 3 7 puts the two g of a
// quarter-warp in chunks whose swizzled places (c ^ row % 8 over the
// quarter-warp's 4 rows) differ, so the 16-byte loads are free of bank
// conflicts.
__device__ __forceinline__ int perm8(int g) { return (g >> 1) | ((g & 1) << 2); }

// The k8 steps of one 128-pixel stage: acc[i][j] (m16 tile i, n8 tile j)
// += TF32(G box rows) x TF32(gathered box rows) of this thread's chunk c.
__device__ __forceinline__ void wgrad_f32_stage(float (&acc)[2][4][4], const uint8_t* gbox,
                                                const uint8_t* abox, int c, int t) {
#pragma unroll 4
  for (int s = 0; s < PATCH / 8; ++s) {
    const int r0 = 8 * s + t, r1 = r0 + 4;
    const float4 g0 = *reinterpret_cast<const float4*>(gbox + r0 * 128 + ((c ^ (r0 & 7)) << 4));
    const float4 g1 = *reinterpret_cast<const float4*>(gbox + r1 * 128 + ((c ^ (r1 & 7)) << 4));
    const float4 x0 = *reinterpret_cast<const float4*>(abox + r0 * 128 + ((c ^ (r0 & 7)) << 4));
    const float4 x1 = *reinterpret_cast<const float4*>(abox + r1 * 128 + ((c ^ (r1 & 7)) << 4));
    const uint32_t ga[4] = {to_tf32(g0.x), to_tf32(g0.y), to_tf32(g0.z), to_tf32(g0.w)};
    const uint32_t gb[4] = {to_tf32(g1.x), to_tf32(g1.y), to_tf32(g1.z), to_tf32(g1.w)};
    const uint32_t xa[4] = {to_tf32(x0.x), to_tf32(x0.y), to_tf32(x0.z), to_tf32(x0.w)};
    const uint32_t xb[4] = {to_tf32(x1.x), to_tf32(x1.y), to_tf32(x1.z), to_tf32(x1.w)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t a[4] = {ga[2 * i], ga[2 * i + 1], gb[2 * i], gb[2 * i + 1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], a, xa[j], xb[j]);
    }
  }
}

// The float32 path's image GEMM: part (nsplit, F, 32) and bpart (nsplit, F)
// as wgrad_image_kernel, on mma.sync TF32 (the G box is MN-major, which
// .tf32 wgmma does not take from shared memory; the GEMM is bound by
// reading G once).  A
// stage: two G boxes (64 f of 32) by TMA and the gathered box of 32
// float32 columns (27 used), rounded to TF32 as the producers store it.
// Warps 0-1 multiply G box w by the gathered box (32 f x 32 columns
// each); warps 2-3 sum G's columns for the bias.  Two blocks an SM.
struct WgradImageF32Smem {
  static constexpr int STAGE = 3 * BOX_BYTES;
  static constexpr int STAGES = RING_BYTES / 2 / STAGE;  // 2
  static constexpr int SB_OFF = STAGES * STAGE;          // bias partials, 4 floats a thread
  static constexpr int BAR_OFF = SB_OFF + 64 * 4 * 4;
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;
};

__global__ void __launch_bounds__(256, 2)
wgrad_image_f32_kernel(const __grid_constant__ CUtensorMap gmap, const float* __restrict__ img,
                       WgradArgs p) {
  using S = WgradImageF32Smem;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x;
  const int f0 = blockIdx.y * 64, s = blockIdx.z, ns = gridDim.z;
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  const long long npatch = static_cast<long long>(p.B) * tiles_hw;
  const int q_begin = static_cast<int>(s * npatch / ns);
  const int n_it = static_cast<int>((s + 1) * npatch / ns) - q_begin;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], 129);  // 128 producers' stores, and the G boxes' bytes
      mbar_init(&empty[i], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warpgroup
    wgrad_image_produce<float, S::STAGES, S::STAGE>(smem, full, empty, &gmap, img, p, q_begin,
                                                    n_it, f0, tid - 128);
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int c = perm8(g);
  const bool gemm = warp < 2, bias = !gemm && p.bpart != nullptr;
  // the bias: thread lt = tid - 64 reads logical chunk lt % 8 (4 f) of G
  // box lt / 32, pixel rows (lt / 8) % 4 + 4 i
  const int lt = tid - 64, bbox = lt >> 5, bchunk = lt & 7, brg = (lt >> 3) & 3;
  float acc[2][4][4], bacc[4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) bacc[e] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S::STAGES;
    mbar_wait(&full[st], (it / S::STAGES) & 1);
    const uint8_t* base = smem + st * S::STAGE;
    if (gemm) wgrad_f32_stage(acc, base + warp * BOX_BYTES, base + 2 * BOX_BYTES, c, t);
    if (bias) {
      const uint8_t* gb = base + bbox * BOX_BYTES;
#pragma unroll 4
      for (int i = 0; i < PATCH / 4; ++i) {
        const int row = brg + 4 * i;
        const float4 v = *reinterpret_cast<const float4*>(gb + row * 128 +
                                                          ((bchunk ^ (row & 7)) << 4));
        bacc[0] += v.x;
        bacc[1] += v.y;
        bacc[2] += v.z;
        bacc[3] += v.w;
      }
    }
    mbar_arrive(&empty[st]);
  }

  if (gemm) {
    float* out = p.part + static_cast<size_t>(s) * p.F * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + 32 * warp + 4 * c + 2 * i + (e >> 1);
        const int col = 4 * perm8(2 * t + (e & 1));
        *reinterpret_cast<float4*>(out + static_cast<size_t>(f) * 32 + col) =
            make_float4(acc[i][0][e], acc[i][1][e], acc[i][2][e], acc[i][3][e]);
      }
  } else if (bias) {  // the 4 threads of each chunk, added in thread order
    float* sb = reinterpret_cast<float*>(smem + S::SB_OFF);
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[lt * 4 + e] = bacc[e];
    bar_sync(2, 64);
    const int box = lt >> 5, fc = lt & 31, chunk = fc >> 2, e = fc & 3;
    float sum = 0.f;
    for (int rr = 0; rr < 4; ++rr) sum += sb[(box * 32 + rr * 8 + chunk) * 4 + e];
    p.bpart[static_cast<size_t>(s) * p.F + f0 + lt] = sum;
  }
}

// Both passes per the record (OP_WGRAD_IMAGE; gout (B, H, W, F) under map
// 0, of the element type T the record names, img (B, H, W, 3) of T): the
// partials into work (nsplit * F * (kp + 1) floats, kp = 64 bf16 / 32
// float32 columns), then dk (F, 3, 3, 3) and db (F).
template <typename T>
cudaError_t launch_wgrad_image(const int64_t* record, const T* gout, const T* img, float* work,
                               float* dk, float* db, int B, int H, int W, int F,
                               cudaStream_t stream) {
  constexpr bool F32 = is_f32<T>();
  constexpr int KP = slice_of<T>();
  const Launch L{record};
  const dim3 grid = L.grid();
  if (L.op() != OP_WGRAD_IMAGE || L.f32() != F32 || L.map(0)[1] != F || L.tile_m() != 64 ||
      L.tile_n() != KP || grid.x != 1 || static_cast<int>(grid.y) * 64 != F ||
      static_cast<int>(grid.z) != L.nsplit())
    return cudaErrorInvalidValue;
  CUtensorMap mg;
  cudaError_t e = make_map(&mg, gout, L.map(0), F32);
  if (e != cudaSuccess) return e;
  float* bpart = work + static_cast<size_t>(L.nsplit()) * F * KP;
  const WgradArgs a{work, bpart, dk, db, B, H, W, 3, F, 3, 0};
  if constexpr (F32) {
    using S = WgradImageF32Smem;
    e = cudaFuncSetAttribute(wgrad_image_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::DYN);
    if (e != cudaSuccess) return e;
    wgrad_image_f32_kernel<<<grid, 256, S::DYN, stream>>>(mg, img, a);
  } else {
    using S = WgradImageSmem;
    e = cudaFuncSetAttribute(wgrad_image_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::DYN);
    if (e != cudaSuccess) return e;
    wgrad_image_kernel<<<grid, 256, S::DYN, stream>>>(mg, img, a);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wgrad_image_reduce_kernel<<<F, 32, 0, stream>>>(work, bpart, dk, db, F, L.nsplit(), KP);
  return cudaGetLastError();
}

// The stage backward of the header note in the element type T, from the C
// entry's untyped pointers.
template <typename T>
int block_bwd(const void* vx, bool is_image, const void* mid0, const void* mid1, const void* vout,
              const void* vdskip, const void* vdpool, const void* wt0, const void* wt1,
              const void* wt2, void* vga, void* vgb, void* vdx, float* work, float* const* dks,
              float* const* dbs, int n, int B, int H, int W, const int* chans,
              const int64_t* plan, cudaStream_t stream) {
  constexpr int EL = 16 / static_cast<int>(sizeof(T));
  const T* x = static_cast<const T*>(vx);
  const T* mids[2] = {static_cast<const T*>(mid0), static_cast<const T*>(mid1)};
  const T* out = static_cast<const T*>(vout);
  const T* dskip = static_cast<const T*>(vdskip);
  const T* dpool = static_cast<const T*>(vdpool);
  const T* wts[3] = {static_cast<const T*>(wt0), static_cast<const T*>(wt1),
                     static_cast<const T*>(wt2)};
  T* ga = static_cast<T*>(vga);
  T* gb = static_cast<T*>(vgb);
  T* dx = static_cast<T*>(vdx);
  const int C = chans[n];
  cudaError_t e;
  if (dpool != nullptr) {
    const size_t m = static_cast<size_t>(B) * (H / 2) * (W / 2) * (C / EL);
    pool_relu_grad_kernel<T><<<static_cast<unsigned>((m + 255) / 256), 256, 0, stream>>>(
        dskip, dpool, out, ga, B, H, W, C);
    e = cudaGetLastError();
  } else {
    e = launch_relu_grad(dskip, out, ga, static_cast<size_t>(B) * H * W * C / EL, stream);
  }
  if (e != cudaSuccess) return e;
  T* g = ga;
  T* g_next = gb;
  for (int i = n - 1; i >= 0; --i) {
    const int cin = chans[i], cout = chans[i + 1];
    const int64_t* wrec = plan + (2 * i) * PLAN_WORDS;
    const int64_t* drec = plan + (2 * i + 1) * PLAN_WORDS;
    if (is_image && i == 0)  // the stem's conv1_1 over the image
      e = launch_wgrad_image<T>(wrec, g, x, work, dks[0], dbs[0], B, H, W, cout, stream);
    else
      e = launch_wgrad_sm90<T>(wrec, g, i == 0 ? x : mids[i - 1], work, dks[i], dbs[i], B, H, W,
                               cin, cout, stream);
    if (e != cudaSuccess) return e;
    if (i > 0) {
      if (drec[0] != OP_DGRAD_MASK) return cudaErrorInvalidValue;
      e = launch_conv_record<T>(drec, g, nullptr, wts[i],
                                ConvArgsT<T>{nullptr, mids[i - 1], g_next, nullptr, H, W, cout,
                                             cin},
                                stream);
    } else if (dx != nullptr) {
      if (drec[0] != OP_DGRAD_SPLIT || Launch{drec}.split() != cin) return cudaErrorInvalidValue;
      e = launch_conv_record<T>(drec, g, nullptr, wts[0],
                                ConvArgsT<T>{nullptr, nullptr, dx, nullptr, H, W, cout, cin},
                                stream);
    }
    if (e != cudaSuccess) return e;
    T* tmp = g;
    g = g_next;
    g_next = tmp;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace sm90
}  // namespace tu

using tu::bf16;

// chans[0..n] the widths (chans[0] == 3 with is_image: x is the image of
// the element type); mids[i] (i < n - 1) the ReLU outputs between the
// convs, out the last one; wts[i] the dgrad weights flipT(w_i) packed (Cin_i,
// 9 * Cout_i), wts[0] unused without dx; dpool null without the pool; ga, gb
// (B, H, W, C_n) scratch; every activation tensor and the packed weights of
// the element type (bf16, or float32 with f32); work holds the largest of
// the convs' weight-gradient work areas (nsplit * C_i+1 * (9 * Cp_i + 1)
// floats; the stem's conv1_1 nsplit * C_1 * (kp + 1)); plan: 2n launch
// records (conv i's weight gradient at 2i, its dgrad at 2i + 1; none for
// the stem's conv1_1 dgrad), naming that type.
extern "C" int tu_vgg_block_bwd(const void* x, int is_image, const void* mid0, const void* mid1,
                                const void* out, const void* dskip, const void* dpool,
                                const void* wt0, const void* wt1, const void* wt2, void* ga,
                                void* gb, void* dx, float* work, float* dk0, float* dk1,
                                float* dk2, float* db0, float* db1, float* db2, int n, int B,
                                int H, int W, int c0, int c1, int c2, int c3, int f32,
                                const int64_t* plan, cudaStream_t stream) {
  namespace sm90 = tu::sm90;
  float* dks[3] = {dk0, dk1, dk2};
  float* dbs[3] = {db0, db1, db2};
  const int chans[4] = {c0, c1, c2, c3};
  if (plan == nullptr || n < 2 || n > 3 || (is_image && (n != 2 || dx != nullptr)))
    return cudaErrorInvalidValue;
  return (f32 ? sm90::block_bwd<float> : sm90::block_bwd<bf16>)(
      x, is_image != 0, mid0, mid1, out, dskip, dpool, wt0, wt1, wt2, ga, gb, dx, work, dks, dbs, n,
      B, H, W, chans, plan, stream);
}
