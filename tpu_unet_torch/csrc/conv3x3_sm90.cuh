// The Hopper conv core: 3x3 SAME convolution as an implicit GEMM on wgmma,
// its operands brought by TMA through an mbarrier ring.
//
// What it computes:
//   out[b, y, x, n] = epi(sum_k A[(b, y, x), k] * Wt[n, k])
// with k = (ky * 3 + kx) * Ct + c, A the NHWC bf16 input and Wt the packed
// weights (F, 9 Ct) of _build.pack_conv3x3 (K contiguous).  The input is
// one map of C channels, or the channel concat of two maps [in | in2]
// (C + C2 = Ct channels: a UnetUp stage's [skip | up2x(x)]) that is never
// stored: each K slice comes from one map or the other.
//
// Tile: M = PH x 16 output pixels (an 8- or 16-row patch: 128 or 256
// pixels; 256 only at TN <= 128), N = TN output
// channels (256, 192, 128 or 64: 192 where 192 divides F and 256 does not,
// else the widest of 256 / 128 / 64 that divides F, as kernels/sm90.py::
// conv_tile_n plans it; instantiations of one kernel).  A K slice is one
// tap and 64 input channels (128 bytes) of one map:
//   A: one 4-D TMA box (64 c, 16 x, PH y, 1 b) of that map at
//      (c0, x0 + kx - 1, y0 + ky - 1, b).  TMA fills every element outside
//      the tensor with zero, which is the SAME padding (and the channels
//      past the map's width when it is no multiple of 64), so the loop has
//      no bounds check and no im2col arithmetic: the addressing lives in
//      the tensor map;
//   B: one 3-D box (64 c, 1 tap, TN n) of the weights viewed as (F, 9, Ct)
//      at the slice's channel offset (c0 for in, C + c0 for in2); weight
//      channels past the slice's map multiply its zero fill.
// Per tap the K walk takes in's ceil(C / 64) slices, then in2's.
// Both land 128-byte swizzled, K-major, which is what wgmma reads.
// Block: 384 threads.  Warpgroups 0 and 1 consume: each issues
// wgmma.mma_async m64nTNk16 on its M / 2 rows (PH / 8 m64 tiles), 4 per
// slice, keeping one slice's products in flight before it releases the
// stage.  Warpgroup 2 produces: one thread waits on a stage's "empty"
// barrier and issues its two TMA loads on the "full" one.  Where the
// epilogue's staging buffer can have shared memory of its own beside a
// ring of at least 4 stages, the kernel is persistent: one block an SM
// walks the tiles, the ring running on across them, so the producer loads
// the next tile's first slices while the consumers store the tile before
// (the ring takes what the 227 KB leave, up to 8 stages).  In bf16 the
// buffer holds the whole tile (TN <= 192 at 128 pixels, TN = 64 at 256:
// 8 stages of 24 KB at TN = 64, 5 of 32 KB at 128, 4 of 40 KB at 192; at
// PH = 16, 4 of 40 KB at 64); else (TN = 256, and TN = 128 at PH = 16,
// whose 3 stages would starve the long K walks of the forward) the ring
// fills 192 KB (4 stages of 48 KB), the epilogue stages its tile in it
// once both consumers are done with it, and a block takes one tile.  A
// 9-slice K walk (a dgrad of 64 channels) ran 29-30% faster persistent on
// an H100.  In float32 every tile is persistent: the epilogue stages a
// chunk of CW columns at a time (conv_chunk: the widest of 64, 32 or 16
// that leaves 4 stages), the accumulators staying in registers until
// their chunk's turn.  TN = 256 reads 85 FLOP a byte from L2 against 77
// at TN = 192, 64 at 128 and 43 at 64 (85 and 52 with the 256-pixel
// tile): at these shapes the operands stream from L2, whose rate bounds
// the smaller tiles.  (A 256 x 192 tile would read 112, but its 192
// accumulators a thread spill under the 168 registers that ptxas gives a
// 384-thread block.)  Tiles are numbered with the TN-tiles of one patch
// adjacent, so the blocks that share a patch's input run together out of
// L2.
//
// Epilogues (template OP; conv_epilogue, which the halo mainloop of
// conv3x3_halo_sm90.cuh calls too): bias + ReLU + bf16 and, with
// OP_FWD_POOL, the 2x2 max-pooled tile too (the forward); the dgrad's
// out = v * [mask > 0] (OP_DGRAD_MASK); the dgrad's plain bf16 store split
// at a channel S that the launch record carries (OP_DGRAD_SPLIT: channels
// [0, S) to out (.., S), [S, F) to out2 (.., F - S); a UnetUp stage's
// [dskip | dups] at S = Cs, a block's dx at S = F).  S % 8 == 0, so every
// 16-byte piece lies on one side; the split may fall inside a tile.  The
// tile is staged in shared memory a chunk of columns at a time (bf16: one
// chunk) and each chunk written coalesced, 16 bytes a thread; the mask
// loads, the split and the pool (per channel) are a chunk's own.
//
// Bound on the H100: operations (2 * 9 * Ct * F multiply-adds a pixel: 64
// to 1024 of them per byte moved at the VGG16 blocks and decoder stages).
// Element type (template T): bf16, or float32 for the float32 training
// path (the voc and medical presets, fp16=False).  In float32 the
// activations, weights and accumulators are float32 and the products TF32
// (wgmma m64nNk8 .tf32).  That is what PyTorch computes for a float32
// convolution on this card (cudnn.allow_tf32 is on by default), so it is
// what the reference's float32 training computes on an H100, and it is at
// least as precise as XLA's default for a float32 convolution on a TPU (one
// bf16 pass).  A K slice is 128 bytes in either type (64 bf16 or 32 float32
// channels): the stage bytes and the 32-byte K steps stay, and the K walk
// is twice as long in float32.  The activation (or gradient) operand goes
// from its TMA box to the tensor cores as it is, so it is truncated to TF32
// (its low 13 mantissa bits unused: an H100 reads 1e-6 to 2e-5 from a
// truncating float64 emulation, 4e-4 to 7e-4 from a rounding one); the
// weights are rounded to nearest when they are packed
// (kernels/_build.py::pack_conv3x3; on the card csrc/pack_weights.cu).
// The epilogue's float32 tile takes twice the bytes, so it is staged in
// chunks of 64, 32 or 16 columns (kernels/sm90.py::conv_chunk), which keep
// every float32 tile persistent beside a ring of 4 stages or more; the K
// walk and the products are those of a tile staged whole.
//
// What the host tells the kernel (grid, tile, shared memory, tensor maps)
// is planned in tpu_unet_torch/kernels/sm90.py and arrives as a launch
// record.  Shapes: H % PH == 0, W % 16 == 0, C % 8 == 0 and C2 % 8 == 0
// (16-byte TMA strides), F % 64 == 0.
#pragma once

#include "sm90.cuh"

namespace tu {
namespace sm90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int PATCH_H = 8, PATCH_W = 16, PATCH = PATCH_H * PATCH_W;  // pixels of a tile
constexpr int BOX_BYTES = PATCH * 128;       // one (128-byte, 16 x, 8 y) box: 16 KB
constexpr int CONSUMERS = 256;               // two consumer warpgroups
constexpr int THREADS = 384;                 // and one producer warpgroup
constexpr int RING_BYTES = 192 * 1024;     // the weight-gradient GEMM's TMA ring
constexpr int SMEM_MAX = 232448;           // a block's dynamic shared memory, 227 KB

// channels of T in a K slice: the 128 bytes of the swizzle span (64 bf16, 32
// float32)
template <typename T>
__host__ __device__ constexpr int slice_of() {
  return 128 / static_cast<int>(sizeof(T));
}

// Ring stages that fit beside an epilogue buffer of `cols` columns of T (and
// 16 bytes a row) at M pixels by TN channels: of the 227 KB, less the
// barriers and 1024 spare bytes (kernels/sm90.py::conv_ring_fit)
template <typename T>
__host__ __device__ constexpr int conv_ring_fit(int m, int tn, int cols) {
  return (SMEM_MAX - 2048 - m * (cols + 16 / static_cast<int>(sizeof(T))) *
                                static_cast<int>(sizeof(T))) /
         ((m + tn) * 128);
}

// The columns the epilogue stages at a time (kernels/sm90.py::conv_chunk):
// bf16 the whole tile; float32 the widest of 64, 32 or 16 whose buffer
// leaves the ring 4 stages (128 x 256: 32, 128 x 192: 64, 256 x 128: 16,
// 256 x 64: 32, 128 x 128 and 128 x 64: 64)
template <typename T>
__host__ __device__ constexpr int conv_chunk(int m, int tn) {
  return !is_f32<T>()                       ? tn
         : conv_ring_fit<T>(m, tn, 64) >= 4 ? 64
         : conv_ring_fit<T>(m, tn, 32) >= 4 ? 32
                                            : 16;
}

template <typename T, int TN, int PH>
struct ConvSmem {
  static constexpr int M = PH * PATCH_W;                       // pixels of the tile
  static constexpr int A_BYTES = M * 128;                      // one input box
  static constexpr int STAGE = A_BYTES + TN * 128;             // A box + B box
  static constexpr int CW = conv_chunk<T>(M, TN);              // columns staged at a time
  static constexpr int LDC = CW + 16 / static_cast<int>(sizeof(T));  // staging row (T)
  static constexpr int OUT_BYTES = M * LDC * static_cast<int>(sizeof(T));  // the epilogue's buffer
  // Where a staging buffer of its own leaves the ring 4 stages (at most 8),
  // a block walks many tiles and the producer fills the ring during the
  // epilogue: every float32 tile, through its chunks, and the bf16 tiles but
  // TN = 256 at 128 pixels and TN = 128 at 256, whose whole tile is staged
  // in the 192 KB ring once the consumers are done with it, a block a tile.
  static constexpr int OWN_FIT = conv_ring_fit<T>(M, TN, CW);
  static constexpr bool OWN = OWN_FIT >= 4;
  static constexpr int STAGES = OWN ? (OWN_FIT < 8 ? OWN_FIT : 8) : RING_BYTES / STAGE;
  static constexpr int OUT_OFF = OWN ? STAGES * STAGE : 0;
  static constexpr int BAR_OFF = STAGES * STAGE + (OWN ? OUT_BYTES : 0);
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;  // + 1024 as sm90.py counts
  static_assert(DYN <= SMEM_MAX && (OWN || OUT_BYTES <= BAR_OFF), "the tiles fit");
  static_assert(OWN || !is_f32<T>(), "every float32 tile is persistent");
  static_assert(TN % CW == 0, "whole chunks");
};

template <typename T>
struct ConvArgsT {
  const float* bias;  // OP_FWD*: (F) float32
  const T* mask;      // OP_DGRAD_MASK: laid out as out
  T* out;             // (B, H, W, F); OP_DGRAD_SPLIT: (B, H, W, split)
  T* pooled;          // OP_FWD_POOL: (B, H / 2, W / 2, F)
  int H, W, C, F;
  int C2;             // channels of the second input map (0: one map)
  T* out2;            // OP_DGRAD_SPLIT: (B, H, W, F - split), null at split == F
  int split;          // OP_DGRAD_SPLIT: set from the launch record
  int tiles;          // output tiles, set from the launch record
};
using ConvArgs = ConvArgsT<bf16>;

// output tile t: the TN channels from n0 of the PH x 16 pixels from (b, y0, x0)
struct Tile {
  int n0, b, y0, x0;
};

template <int TN, int PH, typename A>
__device__ __forceinline__ Tile tile_of(int t, const A& p) {
  const int ntn = p.F / TN, m = t / ntn;
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PH) * tiles_w;
  const int b = m / tiles_hw, thw = m - b * tiles_hw;
  return Tile{(t - m * ntn) * TN, b, (thw / tiles_w) * PH, (thw % tiles_w) * PATCH_W};
}

// The conv's epilogue, shared by conv_sm90_kernel and the halo mainloop
// (conv3x3_halo_sm90.cuh): a tile's accumulators, CW columns at a time
// (they stay in registers until their chunk is staged), in the wgmma
// fragment layout (warp w of consumer warpgroup wg holds rows 16w .. 16w +
// 15 of each of its PH / 8 m64 tiles, rows (wg * PH / 8 + i) * 64 + ...:
// pixel r of the PH x 16 tile is (r / 16, r % 16); lane: row lane / 4 and
// + 8, columns 2 (lane % 4) + {0,1} of every 8-column group) staged as T
// rows of the chunk in `sc` (M rows of CW + 16 bytes), then stored
// coalesced, 16 bytes a thread.
// OP_DGRAD_MASK: a chunk's mask pieces are loaded all at once rather
// than one dependent round trip a piece in the store loop: with one
// chunk once it is staged (the accumulators' registers are free), with
// several a chunk ahead, so that they fly during the barriers and the
// staging.  Each chunk still waits on its loads: a float32 masked
// dgrad of 128 channels runs 128-pixel tiles, two chunks, not eight
// (kernels/sm90.py::conv_tile_m).  The 256 consumer threads call it
// together (named barrier 1).
template <typename T, int TN, int OP, int PH, int CW>
__device__ __forceinline__ void conv_epilogue(float (&acc)[PH / 8][TN / 2],
                                              const ConvArgsT<T>& p, const Tile& tile, T* sc,
                                              int tid) {
  constexpr int MT = PH / 8;                  // m64 tiles of a consumer warpgroup
  constexpr int M = PH * PATCH_W;             // pixels of the tile
  constexpr int EL = 16 / static_cast<int>(sizeof(T));  // elements of a 16-byte piece
  constexpr int LDC = CW + EL;                // staging row (T)
  constexpr int CH = CW / EL;                 // 16-byte pieces of a pixel's chunk
  constexpr int PER = M * CH / CONSUMERS;     // pieces a consumer thread stores a chunk
  static_assert(M * CH % CONSUMERS == 0 && PER <= 16, "the store loop has no ragged end");
  const int wg = tid >> 7, lane = tid & 31;
  const int n0 = tile.n0, b = tile.b, y0 = tile.y0, x0 = tile.x0;
  uint4 mk[OP == OP_DGRAD_MASK ? PER : 1];
  auto load_mask = [&](int c0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int v = tid + j * CONSUMERS, px = v / CH;
      const size_t pix =
          (static_cast<size_t>(b) * p.H + y0 + px / PATCH_W) * p.W + x0 + px % PATCH_W;
      mk[j] = *reinterpret_cast<const uint4*>(p.mask + pix * p.F + n0 + c0 + (v - px * CH) * EL);
    }
  };
  constexpr int NCH = TN / CW;  // chunks of the tile
  if (OP == OP_DGRAD_MASK && NCH > 1) load_mask(0);
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c0 = k * CW;
    // the ring's reads (a staging ring) and the buffer's last reads are done
    bar_sync(1, CONSUMERS);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = (wg * MT + i) * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
      for (int q = 0; q < CW / 8; ++q) {
        const int c = 8 * q + 2 * (lane & 3), a = 4 * (c0 / 8 + q);
        float v0 = acc[i][a], v1 = acc[i][a + 1], v2 = acc[i][a + 2], v3 = acc[i][a + 3];
        if (OP == OP_FWD || OP == OP_FWD_POOL) {
          const float b0 = p.bias[n0 + c0 + c], b1 = p.bias[n0 + c0 + c + 1];
          v0 = fmaxf(v0 + b0, 0.f);
          v1 = fmaxf(v1 + b1, 0.f);
          v2 = fmaxf(v2 + b0, 0.f);
          v3 = fmaxf(v3 + b1, 0.f);
        }
        if constexpr (is_f32<T>()) {
          *reinterpret_cast<float2*>(&sc[r * LDC + c]) = make_float2(v0, v1);
          *reinterpret_cast<float2*>(&sc[(r + 8) * LDC + c]) = make_float2(v2, v3);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(&sc[r * LDC + c]) =
              __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(&sc[(r + 8) * LDC + c]) =
              __floats2bfloat162_rn(v2, v3);
        }
      }
    }
    if (OP == OP_DGRAD_MASK && NCH == 1) load_mask(c0);
    bar_sync(1, CONSUMERS);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int v = tid + j * CONSUMERS;
      const int px = v / CH, sub = v - px * CH;
      const size_t pix =
          (static_cast<size_t>(b) * p.H + y0 + px / PATCH_W) * p.W + x0 + px % PATCH_W;
      const int n = n0 + c0 + sub * EL;
      uint4 val = *reinterpret_cast<const uint4*>(&sc[px * LDC + sub * EL]);
      if (OP == OP_DGRAD_MASK) {
        const T* mv = reinterpret_cast<const T*>(&mk[j]);
        T* vv = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int e = 0; e < EL; ++e)
          if (!(to_f(mv[e]) > 0.f)) vv[e] = from_f<T>(0.f);
        *reinterpret_cast<uint4*>(p.out + pix * p.F + n) = val;
      } else if (OP == OP_DGRAD_SPLIT) {
        if (n < p.split)
          *reinterpret_cast<uint4*>(p.out + pix * p.split + n) = val;
        else
          *reinterpret_cast<uint4*>(p.out2 + pix * (p.F - p.split) + n - p.split) = val;
      } else {
        *reinterpret_cast<uint4*>(p.out + pix * p.F + n) = val;
      }
    }
    if (OP == OP_DGRAD_MASK && k + 1 < NCH) load_mask(c0 + CW);
    if (OP == OP_FWD_POOL) {  // per channel, so a chunk pools whole
      const int Hp = p.H / 2, Wp = p.W / 2;
      for (int v = tid; v < (M / 4) * CH; v += CONSUMERS) {
        const int p2 = v / CH, sub = v - p2 * CH, py = p2 >> 3, px = p2 & 7;
        const T* c00 = &sc[((2 * py) * PATCH_W + 2 * px) * LDC + sub * EL];
        T* dst = p.pooled + ((static_cast<size_t>(b) * Hp + y0 / 2 + py) * Wp + x0 / 2 + px) *
                                p.F + n0 + c0 + sub * EL;
        if constexpr (is_f32<T>()) {
          const float4 q00 = *reinterpret_cast<const float4*>(c00);
          const float4 q01 = *reinterpret_cast<const float4*>(c00 + LDC);
          const float4 q10 = *reinterpret_cast<const float4*>(c00 + PATCH_W * LDC);
          const float4 q11 = *reinterpret_cast<const float4*>(c00 + PATCH_W * LDC + LDC);
          *reinterpret_cast<float4*>(dst) = make_float4(
              fmaxf(fmaxf(q00.x, q01.x), fmaxf(q10.x, q11.x)),
              fmaxf(fmaxf(q00.y, q01.y), fmaxf(q10.y, q11.y)),
              fmaxf(fmaxf(q00.z, q01.z), fmaxf(q10.z, q11.z)),
              fmaxf(fmaxf(q00.w, q01.w), fmaxf(q10.w, q11.w)));
        } else {
          const __nv_bfloat162* q00 = reinterpret_cast<const __nv_bfloat162*>(c00);
          const __nv_bfloat162* q01 = reinterpret_cast<const __nv_bfloat162*>(c00 + LDC);
          const __nv_bfloat162* q10 =
              reinterpret_cast<const __nv_bfloat162*>(c00 + PATCH_W * LDC);
          const __nv_bfloat162* q11 =
              reinterpret_cast<const __nv_bfloat162*>(c00 + PATCH_W * LDC + LDC);
          __align__(16) __nv_bfloat162 mx[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e] = __hmax2(__hmax2(q00[e], q01[e]), __hmax2(q10[e], q11[e]));
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(mx);
        }
      }
    }
  }
}

template <typename T, int TN, int OP, int PH>
__global__ void __launch_bounds__(THREADS, 1)
conv_sm90_kernel(const __grid_constant__ CUtensorMap act, const __grid_constant__ CUtensorMap act2,
                 const __grid_constant__ CUtensorMap wmap, ConvArgsT<T> p) {
  using S = ConvSmem<T, TN, PH>;
  constexpr int SL = slice_of<T>();
  constexpr int MT = PH / 8;  // m64 tiles of a consumer warpgroup
  extern __shared__ __align__(1024) uint8_t smem[];
  T* sc = reinterpret_cast<T*>(smem + S::OUT_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x;
  const int cs0 = (p.C + SL - 1) / SL, cs = cs0 + (p.C2 + SL - 1) / SL;
  const int nk = 9 * cs;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Block i takes tiles i, i + gridDim.x, ... (S::OWN; else gridDim.x is the
  // tile count).  The ring runs on across tiles (its g-th slice in stage
  // g % STAGES), so the producer loads a tile's first slices while the
  // consumers store the one before.
  if (tid >= CONSUMERS) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == CONSUMERS) {
      int g = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile T_ = tile_of<TN, PH>(t, p);
        for (int it = 0; it < nk; ++it, ++g) {
          const int s = g % S::STAGES;
          if (g >= S::STAGES) mbar_wait(&empty[s], ((g / S::STAGES) - 1) & 1);
          const int tap = it / cs, j = it - tap * cs;
          const int ky = tap / 3, kx = tap - 3 * ky;
          const bool first = j < cs0;  // a slice of in, else of in2
          const int c0 = (first ? j : j - cs0) * SL;
          uint8_t* st = smem + s * S::STAGE;
          mbar_expect_tx(&full[s], S::STAGE);
          tma_load_4d(st, first ? &act : &act2, &full[s], c0, T_.x0 + kx - 1, T_.y0 + ky - 1,
                      T_.b);
          tma_load_3d(st + S::A_BYTES, &wmap, &full[s], first ? c0 : p.C + c0, tap, T_.n0);
        }
      }
    }
    return;
  }

  consumer_regs();
  const int wg = tid >> 7;
  int g = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile T_ = tile_of<TN, PH>(t, p);
    float acc[MT][TN / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < TN / 2; ++c) acc[i][c] = 0.f;
    for (int it = 0; it < nk; ++it, ++g) {
      const int s = g % S::STAGES;
      mbar_wait(&full[s], (g / S::STAGES) & 1);
      const uint8_t* st = smem + s * S::STAGE;
      const uint64_t db = desc_sw128(st + S::A_BYTES, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < MT; ++i) {  // rows (wg * MT + i) * 64 of the tile: 8 KB a tile
        const uint64_t da = desc_sw128(st + (wg * MT + i) * (64 * 128), 16, 1024);
#pragma unroll
        for (int k = 0; k < 4; ++k)  // 32 bytes of K a step (k16 bf16, k8 TF32)
          wgmma_k32<T, TN>(acc[i], da + 2 * k, db + 2 * k);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: release its stage
      if (it > 0) mbar_arrive(&empty[(g - 1) % S::STAGES]);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(g - 1) % S::STAGES]);  // the tile's last slice
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_acc(acc[i]);

    conv_epilogue<T, TN, OP, PH, S::CW>(acc, p, T_, sc, tid);
  }
}

template <typename T, int TN, int OP, int PH>
cudaError_t launch_conv_tn(const Launch& L, const T* in, const T* in2, const T* wt,
                           const ConvArgsT<T>& a, cudaStream_t stream) {
  using S = ConvSmem<T, TN, PH>;
  constexpr bool F32 = is_f32<T>();
  CUtensorMap ma, ma2, mw;
  cudaError_t e = make_map(&ma, in, L.map(0), F32);
  if (e != cudaSuccess) return e;
  e = make_map(&mw, wt, L.map(1), F32);
  if (e != cudaSuccess) return e;
  if (L.has_map(2)) {
    if ((e = make_map(&ma2, in2, L.map(2), F32)) != cudaSuccess) return e;
  } else {
    ma2 = ma;  // never read: the K walk has no slice of a second map
  }
  e = cudaFuncSetAttribute(conv_sm90_kernel<T, TN, OP, PH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::DYN);
  if (e != cudaSuccess) return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  ConvArgsT<T> args = a;
  args.tiles = static_cast<int>(L.grid().x);
  const int blocks = S::OWN && args.tiles > sms ? sms : args.tiles;
  conv_sm90_kernel<T, TN, OP, PH><<<blocks, THREADS, S::DYN, stream>>>(ma, ma2, mw, args);
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch_conv_op(const Launch& L, const T* in, const T* in2, const T* wt,
                           const ConvArgsT<T>& a, cudaStream_t stream) {
  if (L.tile_m() == PATCH) {
    if (L.tile_n() == 256) return launch_conv_tn<T, 256, OP, 8>(L, in, in2, wt, a, stream);
    if (L.tile_n() == 192) return launch_conv_tn<T, 192, OP, 8>(L, in, in2, wt, a, stream);
    if (L.tile_n() == 128) return launch_conv_tn<T, 128, OP, 8>(L, in, in2, wt, a, stream);
    if (L.tile_n() == 64) return launch_conv_tn<T, 64, OP, 8>(L, in, in2, wt, a, stream);
  }
  // the 256-pixel tile: the forwards (pooling or not) and the dgrads of
  // 64- and 128-wide output tiles (a decoder's up1 and up2, VGG16 block 2)
  if (L.tile_m() == 2 * PATCH && L.tile_n() == 128)
    return launch_conv_tn<T, 128, OP, 16>(L, in, in2, wt, a, stream);
  if (L.tile_m() == 2 * PATCH && L.tile_n() == 64)
    return launch_conv_tn<T, 64, OP, 16>(L, in, in2, wt, a, stream);
  return cudaErrorInvalidConfiguration;
}

// One conv per its launch record: `in` (B, H, W, C) under map 0, `wt` (F,
// 9 (C + C2)) under map 1 and, where the record has map 2, `in2` (B, H, W,
// C2) under it (a.C2 > 0 exactly then), all of the element type T (bf16 or
// float32), which the record names; a record of the halo mainloop is
// refused.  A split dgrad's record carries its
// split S (0 < S <= F, S % 8 == 0; a.out2 set where S < F).
template <typename T>
struct Same {
  using type = T;
};

template <typename T>
cudaError_t launch_conv_sm90(const int64_t* record, const T* in, const typename Same<T>::type* in2,
                             const T* wt, const ConvArgsT<T>& a, cudaStream_t stream) {
  const Launch L{record};
  if (L.f32() != is_f32<T>() || L.mainloop() != MAINLOOP_TAP || L.has_map(2) != (a.C2 > 0) ||
      (a.C2 > 0 && in2 == nullptr))
    return cudaErrorInvalidValue;
  switch (L.op()) {
    case OP_FWD: return launch_conv_op<T, OP_FWD>(L, in, in2, wt, a, stream);
    case OP_FWD_POOL: return launch_conv_op<T, OP_FWD_POOL>(L, in, in2, wt, a, stream);
    case OP_DGRAD_MASK: return launch_conv_op<T, OP_DGRAD_MASK>(L, in, in2, wt, a, stream);
    case OP_DGRAD_SPLIT: {
      const int s = L.split();
      if (s <= 0 || s > a.F || s % 8 || (s < a.F && a.out2 == nullptr))
        return cudaErrorInvalidValue;
      ConvArgsT<T> args = a;
      args.split = s;
      return launch_conv_op<T, OP_DGRAD_SPLIT>(L, in, in2, wt, args, stream);
    }
    default: return cudaErrorInvalidConfiguration;
  }
}

}  // namespace
}  // namespace sm90
}  // namespace tu
