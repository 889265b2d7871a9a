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
// That is the bf16 GEMM.  The float32 one (further below:
// wgrad_tf32_kernel) computes the same sums on TF32 wgmma with the same
// split-K plan, bias sums and second pass, from boxes of its own: .tf32
// wgmma reads no MN-major operand, so im2col(A)^T goes to the tensor cores
// as register fragments and G is restaged K-major in shared memory by a
// warpgroup of its own (its note says how, and what it reads).
//
// Bound on the H100: operations (2 * 9 * C * F multiply-adds a pixel).
// Shapes: H % 8 == 0, W % 16 == 0, C % 8 == 0 (16-byte TMA strides),
// F % 64 == 0; in float32 the same.
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

// C padded to 64 channels: a bf16 box's, or the float32 GEMM's column
// tile (two 32-channel halo boxes), so a tile never straddles two taps
__host__ __device__ constexpr int tap_width(int C) { return (C + 63) / 64 * 64; }

// The producer of the bf16 GEMM, one thread: for each of the block's n_it
// patches from q_begin, stage it % STAGES (of STAGE bytes) gets ng G boxes
// (64 f each, from f0) and, from box slot a0, na input boxes (each 64
// K-columns of one tap, from k0).
template <int STAGES, int STAGE>
__device__ __forceinline__ void wgrad_produce(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                              const CUtensorMap* gmap, const CUtensorMap* amap,
                                              const WgradArgs& p, int q_begin, int n_it, int f0,
                                              int k0, int ng, int a0, int na) {
  const int Cp = tap_width(p.C);
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) - 1) & 1);
    const int q = q_begin + it, b = q / tiles_hw, thw = q - b * tiles_hw;
    const int y0 = (thw / tiles_w) * PATCH_H, x0 = (thw % tiles_w) * PATCH_W;
    uint8_t* base = smem + st * STAGE;
    mbar_expect_tx(&full[st], (ng + na) * BOX_BYTES);
    for (int w = 0; w < ng; ++w)
      tma_load_4d(base + w * BOX_BYTES, gmap, &full[st], f0 + 64 * w, x0, y0, b);
    for (int h = 0; h < na; ++h) {
      const int kk = k0 + 64 * h, tap = kk / Cp, c = kk - tap * Cp;
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
  const int Cp = tap_width(p.C), K = 9 * Cp;
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
      wgrad_produce<S::STAGES, S::STAGE>(smem, full, empty, &gmap, &amap, p, q_begin, n_it,
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

// ---- the float32 GEMM: TF32 wgmma, G restaged K-major -------------------
//
// .tf32 wgmma reads an operand from shared memory K-major only (no
// transpose bit), and both of this GEMM's operands arrive MN-major: the
// reduction runs over the pixels and every NHWC box holds channels
// innermost.  So one operand goes through registers and the other is
// restaged:
//   A (M = the tile's K-columns, tap x channel; K = pixels): im2col(in)^T
//      as register fragments, which have no major-ness, loaded by the
//      consumers from the MN-major input boxes with 8-byte shared-memory
//      loads;
//   B (N = f; K = pixels): G, restaged K-major by a warpgroup of its own —
//      it reads the G boxes (pixels x 32 f) and writes f rows x 32 pixels
//      in the canonical 128-byte-swizzled layout.
// G is the operand restaged because it is the narrower one a stage (64 f
// against 576 K-columns).  The restager rounds both to TF32 (to_tf32,
// ties away): G as it writes it, and the input boxes in place, each
// element once (consumers that rounded their fragments paid it nine times
// an element, once a tap, their largest cost on an H100).  The tensor
// cores read the rounded words exactly, so both operands are rounded to
// nearest, the rule of every float32 weight-gradient GEMM of the port
// (kernels/tf32.py).
//
// Tile: 64 f x (64 channels x 9 taps) = 576 K-columns, all nine taps of a
// 64-channel slice of the input.  A stage is a 2 x 16 pixel sub-patch (32
// pixels, 4 k8 steps; a split's 8 x 16 patches walked a quarter at a
// time) and holds: two G boxes (32 f, 16 x, 2 y), two halo boxes (32 c, 18
// x, 4 y) of the input at (c0 + 32 h, x0 - 1, y0 - 1) — TMA's zero fill is
// the SAME halo, and one halo box serves all nine taps, each tap a shift
// of the rows the fragments read — and the restaged G: 34 KB, 6 stages.
// Per pixel the tile streams 64 f + 2.25 x 64 channels (the halo) of L2,
// 832 bytes for 73,728 FLOP: 89 FLOP a byte, against 21 of the mma.sync
// GEMM this replaces (128 f x 64 or 64 f x 128 columns, per-tap boxes).
// Block: 512 threads.  Warpgroups 0-2 consume, warpgroup w the taps of
// row ky = w: three m64n64k8 products a k8 step (kx = 0, 1, 2), each 64
// K-columns (one tap's 64 channels) by the 64 f, 96 accumulators a thread
// (setmaxnreg gives the consumers 152 registers and the restager 56;
// ptxas allocates the consumers what it gives them, and with 128 each the
// GEMM ran far slower).  Warpgroup 3 restages, and its thread 0 issues
// the TMA loads: after restaging stage j it refills the slot that stage j
// - 2 left (F32_LAG), so the restager runs up to two stages ahead (one
// held the consumers back).  On an H100 (700 W) the GEMM reads 37-45% of
// its TF32 bound at the port's shapes (PERF.md).  Tried on the card and
// dropped, each slower or no faster: a 128 f x (tap row x 64 channels)
// tile on m64n128k8 (its stages carry a third of the work for the same
// barriers), double-buffered fragments, a lead of 3 stages, the restaging
// inside the consumer warpgroups (384 threads, 168 registers).
//
// Fragment order.  The m64nNk8 .tf32 A fragment: thread (warp v of its
// warpgroup, g = lane / 4, t = lane % 4) holds a0 (row 16 v + g, k t), a1
// (row + 8, k t), a2 (row, k t + 4), a3 (row + 8, k t + 4).  Row 16 v + g
// stands for channel 32 (v / 2) + ch of the tile's slice, row + 8 for ch +
// 1, with ch = 4 chunk + 2 (g % 2), chunk = 2 (v % 2) + g / 4 + 4 ((g % 4)
// / 2): so (a0, a1) and (a2, a3) are two channels next to each other, one
// 8-byte load each, and the 16 lanes of each half-warp read 16 distinct
// 8-byte places of the swizzled rows (chunks c and c ^ 4 over 4
// consecutive rows), free of bank conflicts at any tap shift.  Pixel k of a
// stage is (k / 16, k % 16) of the sub-patch, as the restaged G's K order.
// The restager: thread (warp r, lane l) takes the 4 x 4 block of f 32 (r /
// 2) + 4 j + 0..3 (j = l % 8) by pixels 4 (j ^ d) + 0..3 (d = 4 (r % 2) + l
// / 8): four 16-byte loads, four 16-byte stores, each quarter-warp on 8
// distinct 16-byte places; then 16 bytes at a time of the halo boxes, a
// quarter-warp on one 128-byte row.  It also sums G's columns for the bias
// (the first column tile's blocks), in a fixed order.
constexpr int F32_SUB_H = 2;                                  // a stage: 2 x 16 pixels
constexpr int F32_SUBS = PATCH_H / F32_SUB_H;                 // stages a patch
constexpr int F32_HALO_W = PATCH_W + 2, F32_HALO_H = F32_SUB_H + 2;
constexpr int F32_G_BOX = F32_SUB_H * PATCH_W * 128;          // (32 f, 16 x, 2 y): 4 KB
constexpr int F32_HALO_BOX = F32_HALO_W * F32_HALO_H * 128;   // (32 c, 18 x, 4 y): 9 KB
constexpr int F32_THREADS = 512;  // three consumer warpgroups and the restager's
// the restager's lead: after restaging stage j it refills the slot of stage
// j - F32_LAG, so it may run F32_LAG stages ahead of the consumers
constexpr int F32_LAG = 2;

struct WgradTf32Smem {
  static constexpr int A_OFF = 2 * F32_G_BOX;                // the two halo boxes
  static constexpr int R_OFF = A_OFF + 2 * F32_HALO_BOX;     // G restaged: 64 f x 128 bytes
  static constexpr int STAGE = R_OFF + 64 * 128;             // 34 KB
  static constexpr int STAGES = 6;
  static constexpr int SB_OFF = STAGES * STAGE;              // bias partials, 4 floats a thread
  static constexpr int BAR_OFF = SB_OFF + 128 * 4 * 4;
  static constexpr int DYN = BAR_OFF + 3 * STAGES * 8 + 1024;
  static_assert(STAGE % 1024 == 0 && R_OFF % 1024 == 0 && DYN <= SMEM_MAX, "the ring fits");
};

// stage j of a block's run (patch q_begin + j / 4, its sub-row j % 4) into
// `stage`, completing on `full`: two G boxes from f0, two halo boxes from
// channel c0
__device__ __forceinline__ void wgrad_tf32_load(uint8_t* stage, uint64_t* full,
                                                const CUtensorMap* gmap, const CUtensorMap* amap,
                                                const WgradArgs& p, int q_begin, int j, int f0,
                                                int c0) {
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  const int q = q_begin + j / F32_SUBS, b = q / tiles_hw, thw = q - b * tiles_hw;
  const int y0 = (thw / tiles_w) * PATCH_H + F32_SUB_H * (j % F32_SUBS);
  const int x0 = (thw % tiles_w) * PATCH_W;
  mbar_expect_tx(full, 2 * (F32_G_BOX + F32_HALO_BOX));
  for (int h = 0; h < 2; ++h) {
    tma_load_4d(stage + h * F32_G_BOX, gmap, full, f0 + 32 * h, x0, y0, b);
    tma_load_4d(stage + WgradTf32Smem::A_OFF + h * F32_HALO_BOX, amap, full, c0 + 32 * h,
                x0 - 1, y0 - 1, b);
  }
}

// part (nsplit, F, 9 Cp) float32 (Cp = tap_width(C)), bpart (nsplit, F):
// block (64-channel slice, 64-f tile, split).
__global__ void __launch_bounds__(F32_THREADS, 1)
wgrad_tf32_kernel(const __grid_constant__ CUtensorMap gmap,
                  const __grid_constant__ CUtensorMap amap, WgradArgs p) {
  using S = WgradTf32Smem;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* ready = full + S::STAGES;
  uint64_t* empty = ready + S::STAGES;
  const int tid = threadIdx.x;
  const int Cp = tap_width(p.C), K = 9 * Cp;
  const int c0 = blockIdx.x * 64, f0 = blockIdx.y * 64, s = blockIdx.z, ns = gridDim.z;
  const int tiles_hw = (p.H / PATCH_H) * (p.W / PATCH_W);
  const long long npatch = static_cast<long long>(p.B) * tiles_hw;
  const int q_begin = static_cast<int>(s * npatch / ns);
  const int n_it = (static_cast<int>((s + 1) * npatch / ns) - q_begin) * F32_SUBS;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&ready[i], 128);
      mbar_init(&empty[i], 384);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 384) {  // the restager warpgroup; its thread 0 also loads
    regs_dec<56>();
    const int rt = tid - 384, rw = rt >> 5, jj = rt & 7;
    const int bx = rw >> 1, pq = jj ^ (4 * (rw & 1) + ((rt & 31) >> 3));
    const bool bias = blockIdx.x == 0 && p.bpart != nullptr;
    float bacc[4] = {0.f, 0.f, 0.f, 0.f};
    if (rt == 0)
      for (int i = 0; i < S::STAGES && i < n_it; ++i)
        wgrad_tf32_load(smem + i * S::STAGE, &full[i], &gmap, &amap, p, q_begin, i, f0, c0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % S::STAGES;
      mbar_wait(&full[st], (it / S::STAGES) & 1);
      uint8_t* base = smem + st * S::STAGE;
      // G: the 4 x 4 block of f 32 bx + 4 jj + e by pixels 4 pq + i, K-major
      const uint8_t* gb = base + bx * F32_G_BOX;
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * pq + i;
        v[i] = *reinterpret_cast<const float4*>(gb + row * 128 + ((jj ^ (row & 7)) << 4));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = (&v[0].x)[e], x1 = (&v[1].x)[e], x2 = (&v[2].x)[e], x3 = (&v[3].x)[e];
        const int f = 32 * bx + 4 * jj + e;
        *reinterpret_cast<uint4*>(base + S::R_OFF + f * 128 + ((pq ^ (f & 7)) << 4)) =
            make_uint4(to_tf32(x0), to_tf32(x1), to_tf32(x2), to_tf32(x3));
        if (bias) bacc[e] += ((x0 + x1) + x2) + x3;
      }
      // the halo boxes rounded to TF32 in place, 16 bytes a thread at a time
      // (a quarter-warp on one 128-byte row), so the consumers load their
      // fragments rounded: each element once, not once a tap
      uint4* hb = reinterpret_cast<uint4*>(base + S::A_OFF);
#pragma unroll
      for (int i = 0; i < 2 * F32_HALO_BOX / 16 / 128; ++i) {
        const float4 h = *reinterpret_cast<const float4*>(hb + rt + 128 * i);
        hb[rt + 128 * i] = make_uint4(to_tf32(h.x), to_tf32(h.y), to_tf32(h.z), to_tf32(h.w));
      }
      fence_proxy_async();  // the restaged G is read by wgmma (the async proxy)
      mbar_arrive(&ready[st]);
      if (rt == 0 && it >= F32_LAG && it - F32_LAG + S::STAGES < n_it) {  // refill a slot
        const int sp = (it - F32_LAG) % S::STAGES;
        mbar_wait(&empty[sp], ((it - F32_LAG) / S::STAGES) & 1);
        wgrad_tf32_load(smem + sp * S::STAGE, &full[sp], &gmap, &amap, p, q_begin,
                        it - F32_LAG + S::STAGES, f0, c0);
      }
    }
    if (bias) {  // f = 32 bx + 4 jj + e: the 8 threads of its (bx, jj), added in d order
      float* sb = reinterpret_cast<float*>(smem + S::SB_OFF);
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[rt * 4 + e] = bacc[e];
      bar_sync(1, 128);
      if (rt < 64) {
        const int fb = rt >> 5, fj = (rt & 31) >> 2, fe = rt & 3;
        float sum = 0.f;
        for (int d = 0; d < 8; ++d) sum += sb[((2 * fb + (d >> 2)) * 32 + 8 * (d & 3) + fj) * 4 + fe];
        p.bpart[static_cast<size_t>(s) * p.F + f0 + rt] = sum;
      }
    }
    return;
  }

  regs_inc<152>();
  const int wg = tid >> 7, v = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int chunk = 2 * (v & 1) + (g >> 2) + 4 * ((g & 3) >> 1), half = 8 * (g & 1);
  const int ch = 32 * (v >> 1) + 4 * chunk + 2 * (g & 1);  // row g's channel; row g + 8: ch + 1
  float acc[3][32];
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  uint32_t fr[3][4];
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S::STAGES, ph = (it / S::STAGES) & 1;
    mbar_wait(&full[st], ph);
    mbar_wait(&ready[st], ph);
    const uint8_t* hb = smem + st * S::STAGE + S::A_OFF + (v >> 1) * F32_HALO_BOX;
    const uint64_t dg = desc_sw128(smem + st * S::STAGE + S::R_OFF, 16, 1024);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_wait<0>();  // the last k8 step's products are done: its fragments are free
      if (k == 1 && it > 0) mbar_arrive(&empty[(it - 1) % S::STAGES]);
      const int r0 = ((k >> 1) + wg) * F32_HALO_W + 8 * (k & 1) + t;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        fence_regs(fr[b]);
        const int ra = r0 + b, rb = ra + 4;
        const uint2 x0 = *reinterpret_cast<const uint2*>(hb + ra * 128 +
                                                         ((chunk ^ (ra & 7)) << 4) + half);
        const uint2 x1 = *reinterpret_cast<const uint2*>(hb + rb * 128 +
                                                         ((chunk ^ (rb & 7)) << 4) + half);
        fr[b][0] = x0.x;
        fr[b][1] = x0.y;
        fr[b][2] = x1.x;
        fr[b][3] = x1.y;
      }
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < 3; ++b) wgmma_m64n64k8_tf32_rs(acc[b], fr[b], dg + 2 * k);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < 3; ++b) fence_acc(acc[b]);

  // acc[b][4 i + e]: row g (channel ch), f 8 i + 2 t + e; acc[b][4 i + 2 + e]:
  // row g + 8 (channel ch + 1); block b is tap (wg, b)
  float* out = p.part + static_cast<size_t>(s) * p.F * K;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int col = (3 * wg + b) * Cp + c0 + ch;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = f0 + 8 * i + 2 * t + e;
        *reinterpret_cast<float2*>(out + static_cast<size_t>(f) * K + col) =
            make_float2(acc[b][4 * i + e], acc[b][4 * i + 2 + e]);
      }
  }
}

cudaError_t launch_wgrad_tf32(const Launch& L, const float* gout, const float* in,
                              const WgradArgs& a, cudaStream_t stream) {
  using S = WgradTf32Smem;
  const dim3 grid = L.grid();
  const int64_t *gm = L.map(0), *am = L.map(1);
  if (static_cast<int>(grid.x) * 64 != tap_width(a.C) || static_cast<int>(grid.y) * 64 != a.F ||
      static_cast<int>(grid.z) != L.nsplit() || gm[8] != 32 || gm[9] != PATCH_W ||
      gm[10] != F32_SUB_H || am[8] != 32 || am[9] != F32_HALO_W || am[10] != F32_HALO_H)
    return cudaErrorInvalidConfiguration;
  CUtensorMap mg, ma;
  cudaError_t e = make_map(&mg, gout, gm, true);
  if (e != cudaSuccess) return e;
  e = make_map(&ma, in, am, true);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::DYN);
  if (e != cudaSuccess) return e;
  wgrad_tf32_kernel<<<grid, F32_THREADS, S::DYN, stream>>>(mg, ma, a);
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
  const int Cp = tap_width(C);
  float* bpart = L.bias() ? work + static_cast<size_t>(L.nsplit()) * F * 9 * Cp : nullptr;
  const WgradArgs a{work, bpart, dk, L.bias() ? db : nullptr, B, H, W, C, F,
                    L.out_channels(), L.out_offset()};
  cudaError_t e;
  if constexpr (F32) {
    // 64 f x 576 columns: a 64-channel slice's nine taps
    if (L.tile_m() != 64 || L.tile_n() != 9 * 64) return cudaErrorInvalidConfiguration;
    e = launch_wgrad_tf32(L, gout, in, a, stream);
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
