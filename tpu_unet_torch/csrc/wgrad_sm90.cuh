// The Hopper weight-gradient GEMM of a 3x3 SAME conv: for NHWC input A
// (B, H, W, C) and output gradient G (B, H, W, F), over the pixels p,
//   dk[f, tap * Cp + c] = sum_p G[p, f] * A[p + (ky - 1, kx - 1), c]
//   db[f]               = sum_p G[p, f]
// in float32, D (F x 9Cp) = G^T * im2col(A) with the pixels as the
// reduction dimension, on wgmma and TMA; each tap's C columns padded to
// Cp = 64 * ceil(C / 64).
//
// Operands come straight from TMA boxes of the natural NHWC tensors over
// 8 x 16 pixel patches (a K step of 128 pixels), 128-byte swizzled:
//   A = G^T: two boxes (64 f, 16 x, 8 y, 1 b) at (f0 + 64 w, x0, y0, b), one
//      per consumer warpgroup w: each is M-contiguous (MN-major);
//   B = im2col(A): TN / 64 boxes (64 c, 16 x, 8 y, 1 b) at (c, x0 + kx - 1,
//      y0 + ky - 1, b) for the tap and channels of each 64-column piece of
//      the tile (the padded tap width Cp is a multiple of 64, so a piece
//      never straddles two taps; its channels past C arrive as zeros):
//      N-contiguous (MN-major) too.  TMA's zero fill outside the image is
//      the SAME halo.
// wgmma reads both transposed (imm-trans 1): descriptors with SBO = 1024
// (the next 8 pixel rows) and LBO = the distance between 64-column boxes;
// a k16 step advances 16 pixel rows (2048 bytes).
// Tile: 128 f x TN K-columns (TN = 128, or 64 where Cp % 128 != 0); a
// block reduces one of a fixed number of contiguous ranges of patches
// (split-K, planned on the host to fill the 132 SMs) through a 3-stage
// ring of 64 KB fed by one producer thread, and writes its float32 partial
// tile.  At F = 64 the tile is 64 f x 128 K-columns instead, the two
// warpgroups sharing the G box and taking 64 columns each (3 boxes a
// stage, 4 stages); otherwise, where F % 128 != 0, the last f tile runs
// its first warpgroup only.
// The operands stream from L2 at 64 FLOP a byte, which bounds this tile
// as it does the conv core's 128-wide one; on an H100 a 256-wide tile
// (two 96 KB stages, or four of 48 KB over 4 x 16 patches) and a two-block
// cluster multicasting the input boxes both ran slower.  Where a bias
// gradient is asked for, the blocks of the first column tile also sum G's
// columns from the boxes in shared memory, in a fixed order.  The second
// pass adds the partials in split order and writes the C real columns of
// each tap into channels [coff, coff + C) of a (F, Ctot, 3, 3) gradient:
// a conv over a channel concat [in | in2] (a UnetUp stage's conv1) takes
// one launch per map into the one gradient, never storing the concat.  No
// atomics, so the result is bit-identical run to run.
//
// That is the bf16 GEMM.  The float32 one (further below: wgrad_f32_kernel)
// reads the same boxes through the same producer, splits and second pass,
// and multiplies on mma.sync TF32: .tf32 wgmma takes no transposed operand
// (its note says why this design and what it costs).
//
// Bound on the H100: operations (2 * 9 * C * F multiply-adds a pixel).
// Shapes: H % 8 == 0, W % 16 == 0, C % 8 == 0 (16-byte TMA strides),
// F % 64 == 0.
#pragma once

#include "conv3x3_sm90.cuh"

namespace tu {
namespace sm90 {
namespace {

// A stage: the G boxes (two, one a consumer warpgroup's 64 f; NS: one,
// shared) and the input boxes (TN / 64; NS: two, one a warpgroup's 64
// columns).
template <int TN, bool NS>
struct WgradSmem {
  static constexpr int G_BOXES = NS ? 1 : 2;
  static constexpr int A_BOXES = NS ? 2 : TN / 64;
  static constexpr int STAGE = (G_BOXES + A_BOXES) * BOX_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int SB_OFF = STAGES * STAGE;             // bias partials, 8 floats a thread
  static constexpr int BAR_OFF = SB_OFF + CONSUMERS * 8 * 4;
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;
};

struct WgradArgs {
  float* part;   // (nsplit, F, 9Cp)
  float* bpart;  // (nsplit, F); null: no bias gradient
  float* dk;     // (F, Ctot, 3, 3): this launch writes channels [coff, coff + C)
  float* db;     // (F), with bpart
  int B, H, W, C, F, Ctot, coff;
};

// C padded to a box's channels (64 bf16, 32 float32): a box never straddles
// two taps
template <typename T>
__host__ __device__ constexpr int tap_width(int C) {
  return (C + slice_of<T>() - 1) / slice_of<T>() * slice_of<T>();
}

// The producer of both weight-gradient GEMMs, one thread: for each of the
// block's n_it patches from q_begin, stage it % STAGES (of STAGE bytes)
// gets ng G boxes (SL = slice_of<T>() f each, from f0) and, from box slot
// a0, na input boxes (each SL K-columns of one tap, from k0).
template <typename T, int STAGES, int STAGE>
__device__ __forceinline__ void wgrad_produce(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                              const CUtensorMap* gmap, const CUtensorMap* amap,
                                              const WgradArgs& p, int q_begin, int n_it, int f0,
                                              int k0, int ng, int a0, int na) {
  constexpr int SL = slice_of<T>();
  const int Cp = tap_width<T>(p.C);
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
    const int q = q_begin + it, b = q / tiles_hw, thw = q - b * tiles_hw;
    const int y0 = (thw / tiles_w) * PATCH_H, x0 = (thw % tiles_w) * PATCH_W;
    uint8_t* base = smem + st * STAGE;
    mbar_expect_tx(&full[st], (ng + na) * BOX_BYTES);
    for (int w = 0; w < ng; ++w)
      tma_load_4d(base + w * BOX_BYTES, gmap, &full[st], f0 + SL * w, x0, y0, b);
    for (int h = 0; h < na; ++h) {
      const int kk = k0 + SL * h, tap = kk / Cp, c = kk - tap * Cp;
      const int ky = tap / 3, kx = tap - 3 * ky;
      tma_load_4d(base + (a0 + h) * BOX_BYTES, amap, &full[st], c, x0 + kx - 1, y0 + ky - 1, b);
    }
  }
}

// TN: the output columns of a warpgroup.  NS = false: a block's tile is
// 128 f (a warpgroup's 64 each) x TN columns; NS = true (a 64-row f tile,
// F = 64): 64 f x 2 TN columns, the warpgroups sharing the G box and
// taking 64 columns each (TN = 64), so neither idles.
template <int TN, bool NS>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_sm90_kernel(const __grid_constant__ CUtensorMap gmap,
                  const __grid_constant__ CUtensorMap amap, WgradArgs p) {
  using S = WgradSmem<TN, NS>;
  constexpr int BLOCK_N = NS ? 2 * TN : TN, BLOCK_F = NS ? 64 : 128;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x;
  const int Cp = tap_width<bf16>(p.C), K = 9 * Cp;
  const int k0 = blockIdx.x * BLOCK_N, f0 = blockIdx.y * BLOCK_F, s = blockIdx.z, ns = gridDim.z;
  // active consumer warpgroups: a 64-row f tile, or (NS) a last 64 columns
  const int nwg = NS ? (k0 + TN < K ? 2 : 1) : (p.F - f0 >= 128 ? 2 : 1);
  const int ng = NS ? 1 : nwg, na = NS ? nwg : TN / 64;  // boxes a stage
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  const long long npatch = static_cast<long long>(p.B) * tiles_hw;
  const int q_begin = static_cast<int>(s * npatch / ns);
  const int n_it = static_cast<int>((s + 1) * npatch / ns) - q_begin;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * nwg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == CONSUMERS)
      wgrad_produce<bf16, S::STAGES, S::STAGE>(smem, full, empty, &gmap, &amap, p, q_begin, n_it,
                                               f0, k0, ng, S::G_BOXES, na);
    return;
  }

  consumer_regs();
  const int wg = tid >> 7, lt = tid & 127, lane = tid & 31;
  if (wg >= nwg) return;
  // the bias sums, from the G box a warpgroup reads (NS: warpgroup 0's)
  const bool bias = blockIdx.x == 0 && p.bpart != nullptr && (!NS || wg == 0);
  const int gbox = NS ? 0 : wg, abox = S::G_BOXES + (NS ? wg : 0);
  float acc[TN / 2], bacc[8];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) bacc[j] = 0.f;
  // the bias sums: thread lt reads logical 16-byte chunk lt & 7 (8 channels)
  // of pixel rows lt / 8 + 16 i, found at physical chunk (lt & 7) ^ (row & 7)
  const int bchunk = ((lt & 7) ^ ((lt >> 3) & 7)) * 16;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S::STAGES;
    mbar_wait(&full[st], (it / S::STAGES) & 1);
    const uint8_t* base = smem + st * S::STAGE;
    const uint64_t da = desc_sw128(base + gbox * BOX_BYTES, BOX_BYTES, 1024);
    const uint64_t db = desc_sw128(base + abox * BOX_BYTES, BOX_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < PATCH / 16; ++k)  // 16 pixel rows (2048 bytes) a step
      wgmma<TN, 1, 1>(acc, da + 128 * k, db + 128 * k, 1);
    wgmma_commit();
    if (bias) {
      const uint8_t* g = base + gbox * BOX_BYTES + (lt >> 3) * 128 + bchunk;
#pragma unroll
      for (int i = 0; i < PATCH / 16; ++i) {
        const uint4 u = *reinterpret_cast<const uint4*>(g + i * 16 * 128);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) bacc[j] += __bfloat162float(v[j]);
      }
    }
    wgmma_wait<1>();  // the previous step's products are done: release its stage
    if (it > 0) mbar_arrive(&empty[(it - 1) % S::STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  float* out = p.part + static_cast<size_t>(s) * p.F * K;
  const int f = f0 + (NS ? 0 : wg * 64) + (lt >> 5) * 16 + (lane >> 2);
  const int kw = k0 + (NS ? wg * TN : 0);
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
    const int k = kw + 8 * i + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(f) * K + k) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(f + 8) * K + k) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  if (bias) {  // the 16 threads of each chunk, added in thread order
    const int nb = NS ? 1 : nwg;  // warpgroups summing a bias
    float* sb = reinterpret_cast<float*>(smem + S::SB_OFF) + wg * 128 * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) sb[lt * 8 + j] = bacc[j];
    bar_sync(1, 128 * nb);
    if (lt < 64) {
      const int chunk = lt >> 3, j = lt & 7;
      float sum = 0.f;
      for (int rr = 0; rr < 16; ++rr) sum += sb[(rr * 8 + chunk) * 8 + j];
      p.bpart[static_cast<size_t>(s) * p.F + f0 + gbox * 64 + lt] = sum;
    }
  }
}

// dk[f, coff + c, tap] = sum over splits of part (nsplit, F, 9Cp) at
// column tap * Cp + c (c < C; the padding columns dropped; Cp the tap width
// of the GEMM's element type), in split order;
// db (F) likewise from bpart (nsplit, F) where bpart is given.  A block
// takes one f and REDUCE_C channels of all 9 taps: it reads 9 runs of
// REDUCE_C consecutive partials and writes one run of 9 REDUCE_C
// consecutive gradients, both coalesced, through shared memory.
constexpr int REDUCE_C = 32;

__global__ void __launch_bounds__(9 * REDUCE_C)
wgrad_sm90_reduce_kernel(const float* __restrict__ part, const float* __restrict__ bpart,
                         float* __restrict__ dk, float* __restrict__ db, int F, int C, int Cp,
                         int Ctot, int coff, int nsplit) {
  __shared__ float t[9 * REDUCE_C];
  const int K = 9 * Cp;
  const size_t n = static_cast<size_t>(F) * K;
  const int f = blockIdx.y, c0 = blockIdx.x * REDUCE_C, tid = threadIdx.x;
  const int tap = tid / REDUCE_C, j = tid - tap * REDUCE_C;
  const int nc = min(REDUCE_C, C - c0);
  if (j < nc) {
    const size_t idx = static_cast<size_t>(f) * K + tap * Cp + c0 + j;
    float sum = 0.f;
    for (int i = 0; i < nsplit; ++i) sum += part[i * n + idx];
    t[j * 9 + tap] = sum;
  }
  __syncthreads();
  if (tid < 9 * nc) dk[(static_cast<size_t>(f) * Ctot + coff + c0) * 9 + tid] = t[tid];
  if (bpart != nullptr && blockIdx.x == 0 && tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < nsplit; ++i) sum += bpart[static_cast<size_t>(i) * F + f];
    db[f] = sum;
  }
}

// ---- the float32 path: TF32 on mma.sync -----------------------------------
//
// In float32 both operands arrive MN-major, as in bf16 (channels innermost
// in every NHWC box, the reduction over the pixels), and .tf32 wgmma takes
// no transposed operand.  This GEMM therefore runs on mma.sync m16n8k8
// (TF32, float32 accumulators), its fragments loaded from the same
// swizzled TMA boxes with 16-byte shared-memory loads and rounded to TF32
// (to_tf32, ties away) in registers: the simple kernel that is right, with
// no copy of either operand and the producer, split-K, bias sums and
// second pass of the bf16 GEMM.  The other ways a K-major operand could
// reach wgmma cost more code or more bytes: restaging an operand K-major
// in shared memory (a pass over every box, by the consumers or a
// warpgroup of its own) or a transposed copy of it written once a layer
// (its bytes in device memory).  The price of this one: mma.sync runs at
// about half of wgmma's TF32 rate, and the fragments' shared-memory loads
// compete with it (on an H100 the GEMM reads 17-19% of its TF32 bound at
// unet_vgg's shapes, PERF.md), a redesign queued in ROADMAP §2.  A box
// holds 32 float32 channels (128 bytes) of 128 pixels.  Tile: BF f x BN
// K-columns, BF = 128 and BN = 64 (4 G boxes and 2 input boxes a stage)
// or, at F = 64, BF = 64 and BN = 128 (2 and 4): 96 KB a stage, 2 stages
// in the 192 KB ring.  Warp w (of 8)
// owns 32 f of G box w % NG by 32 columns of input box w / NG: 2 x 4
// m16n8 products a k8 step of 8 pixels.
//
// Fragment order.  Thread (g = lane / 4, t = lane % 4) loads, for pixel
// rows t and t + 4 of the step, one 16-byte chunk of its warp's G box and
// one of its input box: logical chunk c = PERM[g] (4 consecutive f, 4
// consecutive columns).  Its four f are the rows (tile i, row g + 8 h) of
// its m16 tiles, f = 4 PERM[g] + 2 i + h, and its four columns are column
// g of its n8 tiles j, col = 4 PERM[g] + j; an accumulator's column 2t + e
// is col 4 PERM[2t + e] + j.  PERM = 0 4 1 5 2 6 3 7 puts the two g of a
// quarter-warp in chunks whose swizzled places (c ^ row % 8 over the
// quarter-warp's 4 rows) differ, so the 16-byte loads are free of bank
// conflicts.
__device__ __forceinline__ int perm8(int g) { return (g >> 1) | ((g & 1) << 2); }

template <int NG, int NA>
struct WgradF32Smem {
  static constexpr int STAGE = (NG + NA) * BOX_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int SB_OFF = STAGES * STAGE;  // bias partials, 4 floats a consumer thread
  static constexpr int BAR_OFF = SB_OFF + CONSUMERS * 4 * 4;
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(NG * NA == 8 && STAGES >= 2 && DYN <= SMEM_MAX, "8 warps, 2 stages");
};

// The k8 steps of one 128-pixel stage: acc[i][j] (m16 tile i, n8 tile j)
// += TF32(G box rows) x TF32(input box rows) of this thread's chunk c.
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

// part (nsplit, F, 9 Cp) float32 (Cp = tap_width<float>(C)), bpart (nsplit,
// F): block (column tile, f tile, split) as the bf16 kernel; threads 0-255
// consume, one thread of the producer warpgroup loads.
template <int NG, int NA>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_f32_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap amap,
                 WgradArgs p) {
  using S = WgradF32Smem<NG, NA>;
  constexpr int BN = 32 * NA, BF = 32 * NG;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x;
  const int Cp = tap_width<float>(p.C), K = 9 * Cp;
  const int k0 = blockIdx.x * BN, f0 = blockIdx.y * BF, s = blockIdx.z, ns = gridDim.z;
  const int na = min(NA, (K - k0) / 32);  // the tile's input boxes (the last may hold fewer)
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  const long long npatch = static_cast<long long>(p.B) * tiles_hw;
  const int q_begin = static_cast<int>(s * npatch / ns);
  const int n_it = static_cast<int>((s + 1) * npatch / ns) - q_begin;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == CONSUMERS)
      wgrad_produce<float, S::STAGES, S::STAGE>(smem, full, empty, &gmap, &amap, p, q_begin,
                                                n_it, f0, k0, NG, NG, na);
    return;
  }

  consumer_regs();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int fw = warp % NG, cw = warp / NG;
  const bool active = cw < na;
  const int c = perm8(g);
  // the bias sums (the first column tile's blocks): TPB threads a G box,
  // thread lt reading logical chunk lt % 8 (4 f) of pixel rows lt / 8 +
  // (TPB / 8) i
  constexpr int TPB = CONSUMERS / NG, RG = TPB / 8;
  const bool bias = blockIdx.x == 0 && p.bpart != nullptr;
  const int bbox = tid / TPB, blt = tid % TPB, bchunk = blt & 7, brg = blt >> 3;
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
    if (active) wgrad_f32_stage(acc, base + fw * BOX_BYTES, base + (NG + cw) * BOX_BYTES, c, t);
    if (bias) {
      const uint8_t* gb = base + bbox * BOX_BYTES;
#pragma unroll 4
      for (int i = 0; i < PATCH / RG; ++i) {
        const int row = brg + RG * i;
        const float4 v = *reinterpret_cast<const float4*>(gb + row * 128 +
                                                          ((bchunk ^ (row & 7)) << 4));
        bacc[0] += v.x;
        bacc[1] += v.y;
        bacc[2] += v.z;
        bacc[3] += v.w;
      }
    }
    mbar_arrive(&empty[st]);  // this thread's reads of the stage are done
  }

  if (active) {
    float* out = p.part + static_cast<size_t>(s) * p.F * K;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + 32 * fw + 4 * c + 2 * i + (e >> 1);
        const int col = k0 + 32 * cw + 4 * perm8(2 * t + (e & 1));
        *reinterpret_cast<float4*>(out + static_cast<size_t>(f) * K + col) =
            make_float4(acc[i][0][e], acc[i][1][e], acc[i][2][e], acc[i][3][e]);
      }
  }
  if (bias) {  // the RG threads of each chunk, added in thread order
    float* sb = reinterpret_cast<float*>(smem + S::SB_OFF);
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[tid * 4 + e] = bacc[e];
    bar_sync(1, CONSUMERS);
    if (tid < BF) {
      const int box = tid >> 5, fc = tid & 31, chunk = fc >> 2, e = fc & 3;
      float sum = 0.f;
      for (int rr = 0; rr < RG; ++rr) sum += sb[(box * TPB + rr * 8 + chunk) * 4 + e];
      p.bpart[static_cast<size_t>(s) * p.F + f0 + tid] = sum;
    }
  }
}

template <int NG, int NA>
cudaError_t launch_wgrad_f32(const Launch& L, const float* gout, const float* in,
                             const WgradArgs& a, cudaStream_t stream) {
  using S = WgradF32Smem<NG, NA>;
  const dim3 grid = L.grid();
  if (static_cast<int>(grid.z) != L.nsplit()) return cudaErrorInvalidConfiguration;
  CUtensorMap mg, ma;
  cudaError_t e = make_map(&mg, gout, L.map(0), true);
  if (e != cudaSuccess) return e;
  e = make_map(&ma, in, L.map(1), true);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(wgrad_f32_kernel<NG, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S::DYN);
  if (e != cudaSuccess) return e;
  wgrad_f32_kernel<NG, NA><<<grid, THREADS, S::DYN, stream>>>(mg, ma, a);
  return cudaGetLastError();
}

template <int TN, bool NS>
cudaError_t launch_wgrad_tn(const Launch& L, const bf16* gout, const bf16* in,
                            const WgradArgs& a, cudaStream_t stream) {
  using S = WgradSmem<TN, NS>;
  const dim3 grid = L.grid();
  if (static_cast<int>(grid.z) != L.nsplit()) return cudaErrorInvalidConfiguration;
  CUtensorMap mg, ma;
  cudaError_t e = make_map(&mg, gout, L.map(0));
  if (e != cudaSuccess) return e;
  e = make_map(&ma, in, L.map(1));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(wgrad_sm90_kernel<TN, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S::DYN);
  if (e != cudaSuccess) return e;
  wgrad_sm90_kernel<TN, NS><<<grid, THREADS, S::DYN, stream>>>(mg, ma, a);
  return cudaGetLastError();
}

// Both passes per the GEMM's launch record (gout (B, H, W, F) under map 0,
// in (B, H, W, C) under map 1, both of the element type T that the record
// names) on `stream`: the partials into `work` (nsplit * F * (9 * Cp + 1)
// floats, Cp the type's tap width), then their sums into channels
// [out_offset, out_offset + C) of dk (F, out_channels, 3, 3) and, where the
// record asks for it, the bias gradient into db (F).
template <typename T>
cudaError_t launch_wgrad_sm90(const int64_t* record, const T* gout, const T* in, float* work,
                              float* dk, float* db, int B, int H, int W, int C, int F,
                              cudaStream_t stream) {
  const Launch L{record};
  constexpr bool F32 = is_f32<T>();
  if (L.op() != OP_WGRAD || L.f32() != F32 || L.map(1)[1] != C || L.map(0)[1] != F ||
      L.out_offset() + C > L.out_channels() || (L.bias() && db == nullptr))
    return cudaErrorInvalidValue;
  const int Cp = tap_width<T>(C);
  float* bpart = L.bias() ? work + static_cast<size_t>(L.nsplit()) * F * 9 * Cp : nullptr;
  const WgradArgs a{work, bpart, dk, L.bias() ? db : nullptr, B, H, W, C, F,
                    L.out_channels(), L.out_offset()};
  cudaError_t e;
  if constexpr (F32) {
    // 128 f x 64 columns, or 64 f x 128 columns (a 64-wide F)
    if (L.tile_m() == 128 && L.tile_n() == 64 && F % 128 == 0)
      e = launch_wgrad_f32<4, 2>(L, gout, in, a, stream);
    else if (L.tile_m() == 64 && L.tile_n() == 128 && F % 64 == 0)
      e = launch_wgrad_f32<2, 4>(L, gout, in, a, stream);
    else
      return cudaErrorInvalidConfiguration;
  } else {
    // the record's tile: 128 f x tile_n columns, or 64 f x 128 columns with
    // the warpgroups splitting the columns (a 64-wide F)
    if (L.tile_m() == 64 && L.tile_n() == 128)
      e = launch_wgrad_tn<64, true>(L, gout, in, a, stream);
    else if (L.tile_m() == 128 && L.tile_n() == 128)
      e = launch_wgrad_tn<128, false>(L, gout, in, a, stream);
    else if (L.tile_m() == 128 && L.tile_n() == 64)
      e = launch_wgrad_tn<64, false>(L, gout, in, a, stream);
    else
      return cudaErrorInvalidConfiguration;
  }
  if (e != cudaSuccess) return e;
  wgrad_sm90_reduce_kernel<<<dim3((C + REDUCE_C - 1) / REDUCE_C, F), 9 * REDUCE_C, 0, stream>>>(
      a.part, a.bpart, a.dk, a.db, F, C, Cp, a.Ctot, a.coff, L.nsplit());
  return cudaGetLastError();
}

}  // namespace
}  // namespace sm90
}  // namespace tu
