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
// epilogue's bf16 tile can have shared memory of its own beside a ring of
// at least 4 stages (TN <= 192 at 128 pixels, TN = 64 at 256), the kernel
// is persistent: one block an SM walks the tiles, the ring running on
// across them, so the producer loads the next tile's first slices while
// the consumers store the tile before (the ring takes what the 227 KB
// leave, up to 8 stages: 8 of 24 KB at TN = 64, 5 of 32 KB at 128, 4 of
// 40 KB at 192; at PH = 16, 4 of 40 KB at 64).  Else (TN = 256, and TN =
// 128 at PH = 16, whose 3 stages would starve the long K walks of the
// forward) the ring fills 192 KB (4 stages of 48 KB), the epilogue stages
// its tile in it once both consumers are done with it, and a block takes
// one tile.  A 9-slice K walk (a dgrad of 64 channels) ran 29-30% faster
// persistent on an H100.  TN = 256 reads 85 FLOP a byte from L2 against 77
// at TN = 192, 64 at 128 and 43 at 64 (85 and 52 with the 256-pixel
// tile): at these shapes the operands stream from L2, whose rate bounds
// the smaller tiles.  (A 256 x 192 tile would read 112, but its 192
// accumulators a thread spill under the 168 registers that ptxas gives a
// 384-thread block.)  Tiles are numbered with the TN-tiles of one patch
// adjacent, so the blocks that share a patch's input run together out of
// L2.
//
// Epilogues (template OP): bias + ReLU + bf16 and, with
// OP_FWD_POOL, the 2x2 max-pooled tile too (the forward); the dgrad's
// out = v * [mask > 0] (OP_DGRAD_MASK); the dgrad's plain bf16 store split
// at a channel S that the launch record carries (OP_DGRAD_SPLIT: channels
// [0, S) to out (.., S), [S, F) to out2 (.., F - S); a UnetUp stage's
// [dskip | dups] at S = Cs, a block's dx at S = F).  S % 8 == 0, so every
// 16-byte chunk lies on one side; the split may fall inside a tile.  The
// tile is staged in shared memory and written coalesced, 16 bytes a
// thread.
//
// Bound on the H100: operations (2 * 9 * Ct * F multiply-adds a pixel: 64
// to 1024 of them per byte moved at the VGG16 blocks and decoder stages).
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
constexpr int SLICE_C = 64;                  // input channels of a K slice (128 bytes)
constexpr int BOX_BYTES = PATCH * SLICE_C * 2;  // one (64 c, 16 x, 8 y) box: 16 KB
constexpr int CONSUMERS = 256;               // two consumer warpgroups
constexpr int THREADS = 384;                 // and one producer warpgroup
constexpr int RING_BYTES = 192 * 1024;     // the weight-gradient GEMM's TMA ring
constexpr int SMEM_MAX = 232448;           // a block's dynamic shared memory, 227 KB

template <int TN, int PH>
struct ConvSmem {
  static constexpr int M = PH * PATCH_W;                       // pixels of the tile
  static constexpr int A_BYTES = M * SLICE_C * 2;              // one input box
  static constexpr int STAGE = A_BYTES + TN * SLICE_C * 2;     // A box + B box
  static constexpr int LDC = TN + 8;                           // staging row (bf16)
  static constexpr int OUT_BYTES = M * LDC * 2;                // the epilogue's tile
  // Where a staging tile of its own leaves the ring 4 stages (of the 227 KB,
  // less the barriers and the 1024 bytes of alignment slack; at most 8), a
  // block walks many tiles and the producer fills the ring during the
  // epilogue; else (TN = 256 at 128 pixels, TN = 128 at 256, which 3 stages
  // would starve) the tile is staged in the 192 KB ring and a block takes one.
  static constexpr int OWN_FIT = (SMEM_MAX - 2048 - OUT_BYTES) / STAGE;
  static constexpr bool OWN = OWN_FIT >= 4;
  static constexpr int STAGES = OWN ? (OWN_FIT < 8 ? OWN_FIT : 8) : RING_BYTES / STAGE;
  static constexpr int OUT_OFF = OWN ? STAGES * STAGE : 0;
  static constexpr int BAR_OFF = STAGES * STAGE + (OWN ? OUT_BYTES : 0);
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(DYN <= SMEM_MAX && (OWN || OUT_BYTES <= BAR_OFF), "the tiles fit");
};

struct ConvArgs {
  const float* bias;  // OP_FWD*: (F) float32
  const bf16* mask;   // OP_DGRAD_MASK: laid out as out
  bf16* out;          // (B, H, W, F); OP_DGRAD_SPLIT: (B, H, W, split)
  bf16* pooled;       // OP_FWD_POOL: (B, H / 2, W / 2, F)
  int H, W, C, F;
  int C2;             // channels of the second input map (0: one map)
  bf16* out2;         // OP_DGRAD_SPLIT: (B, H, W, F - split), null at split == F
  int split;          // OP_DGRAD_SPLIT: set from the launch record
  int tiles;          // output tiles, set from the launch record
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// output tile t: the TN channels from n0 of the PH x 16 pixels from (b, y0, x0)
struct Tile {
  int n0, b, y0, x0;
};

template <int TN, int PH>
__device__ __forceinline__ Tile tile_of(int t, const ConvArgs& p) {
  const int ntn = p.F / TN, m = t / ntn;
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PH) * tiles_w;
  const int b = m / tiles_hw, thw = m - b * tiles_hw;
  return Tile{(t - m * ntn) * TN, b, (thw / tiles_w) * PH, (thw % tiles_w) * PATCH_W};
}

template <int TN, int OP, int PH>
__global__ void __launch_bounds__(THREADS, 1)
conv_sm90_kernel(const __grid_constant__ CUtensorMap act, const __grid_constant__ CUtensorMap act2,
                 const __grid_constant__ CUtensorMap wmap, ConvArgs p) {
  using S = ConvSmem<TN, PH>;
  constexpr int MT = PH / 8;  // m64 tiles of a consumer warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  bf16* sc = reinterpret_cast<bf16*>(smem + S::OUT_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x;
  const int cs0 = (p.C + SLICE_C - 1) / SLICE_C, cs = cs0 + (p.C2 + SLICE_C - 1) / SLICE_C;
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
        const Tile T = tile_of<TN, PH>(t, p);
        for (int it = 0; it < nk; ++it, ++g) {
          const int s = g % S::STAGES;
          if (g >= S::STAGES) mbar_wait(&empty[s], ((g / S::STAGES) - 1) & 1);
          const int tap = it / cs, j = it - tap * cs;
          const int ky = tap / 3, kx = tap - 3 * ky;
          const bool first = j < cs0;  // a slice of in, else of in2
          const int c0 = (first ? j : j - cs0) * SLICE_C;
          uint8_t* st = smem + s * S::STAGE;
          mbar_expect_tx(&full[s], S::STAGE);
          tma_load_4d(st, first ? &act : &act2, &full[s], c0, T.x0 + kx - 1, T.y0 + ky - 1, T.b);
          tma_load_3d(st + S::A_BYTES, &wmap, &full[s], first ? c0 : p.C + c0, tap, T.n0);
        }
      }
    }
    return;
  }

  consumer_regs();
  const int wg = tid >> 7;
  const int lane = tid & 31;
  constexpr int CH = TN / 8;                 // 16-byte chunks of a pixel's TN channels
  constexpr int PER = S::M * CH / CONSUMERS;  // chunks a consumer thread stores
  static_assert(S::M * CH % CONSUMERS == 0, "the store loop has no ragged end");
  int g = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile T = tile_of<TN, PH>(t, p);
    const int n0 = T.n0, b = T.b, y0 = T.y0, x0 = T.x0;
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
        const uint64_t da = desc_sw128(st + (wg * MT + i) * (64 * SLICE_C * 2), 16, 1024);
#pragma unroll
        for (int k = 0; k < SLICE_C / 16; ++k)  // 32 bytes of K a step
          wgmma<TN, 0, 0>(acc[i], da + 2 * k, db + 2 * k, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: release its stage
      if (it > 0) mbar_arrive(&empty[(g - 1) % S::STAGES]);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(g - 1) % S::STAGES]);  // the tile's last slice
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
    bar_sync(1, CONSUMERS);  // the ring's reads, and the tile before's stores, are done

    // epilogue: the wgmma fragment (warp w of the warpgroup holds rows
    // 16w .. 16w + 15 of each m64 tile; lane: row lane / 4 and + 8, columns
    // 2 (lane % 4) + {0,1} of every 8-column group) staged as bf16 rows of
    // the tile
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = (wg * MT + i) * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
      for (int q = 0; q < TN / 8; ++q) {
        const int c = 8 * q + 2 * (lane & 3);
        float v0 = acc[i][4 * q], v1 = acc[i][4 * q + 1], v2 = acc[i][4 * q + 2],
              v3 = acc[i][4 * q + 3];
        if (OP == OP_FWD || OP == OP_FWD_POOL) {
          const float b0 = p.bias[n0 + c], b1 = p.bias[n0 + c + 1];
          v0 = fmaxf(v0 + b0, 0.f);
          v1 = fmaxf(v1 + b1, 0.f);
          v2 = fmaxf(v2 + b0, 0.f);
          v3 = fmaxf(v3 + b1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(&sc[r * S::LDC + c]) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(&sc[(r + 8) * S::LDC + c]) =
            __floats2bfloat162_rn(v2, v3);
      }
    }
    // OP_DGRAD_MASK: this thread's mask chunks, loaded all at once (the
    // accumulators are staged, so their registers are free) rather than one
    // dependent round trip a chunk in the store loop
    uint4 mk[OP == OP_DGRAD_MASK ? PER : 1];
    if (OP == OP_DGRAD_MASK) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int v = tid + j * CONSUMERS, px = v / CH;
        const size_t pix =
            (static_cast<size_t>(b) * p.H + y0 + px / PATCH_W) * p.W + x0 + px % PATCH_W;
        mk[j] = *reinterpret_cast<const uint4*>(p.mask + pix * p.F + n0 + (v - px * CH) * 8);
      }
    }
    bar_sync(1, CONSUMERS);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int v = tid + j * CONSUMERS;
      const int px = v / CH, sub = v - px * CH;
      const size_t pix =
          (static_cast<size_t>(b) * p.H + y0 + px / PATCH_W) * p.W + x0 + px % PATCH_W;
      const int n = n0 + sub * 8;
      uint4 val = *reinterpret_cast<const uint4*>(&sc[px * S::LDC + sub * 8]);
      if (OP == OP_DGRAD_MASK) {
        const bf16* mv = reinterpret_cast<const bf16*>(&mk[j]);
        bf16* vv = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (!(__bfloat162float(mv[e]) > 0.f)) vv[e] = __float2bfloat16_rn(0.f);
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
    if (OP == OP_FWD_POOL) {
      const int Hp = p.H / 2, Wp = p.W / 2;
      for (int v = tid; v < (S::M / 4) * CH; v += CONSUMERS) {
        const int p2 = v / CH, sub = v - p2 * CH, py = p2 >> 3, px = p2 & 7;
        const bf16* c00 = &sc[((2 * py) * PATCH_W + 2 * px) * S::LDC + sub * 8];
        const __nv_bfloat162* q00 = reinterpret_cast<const __nv_bfloat162*>(c00);
        const __nv_bfloat162* q01 = reinterpret_cast<const __nv_bfloat162*>(c00 + S::LDC);
        const __nv_bfloat162* q10 = reinterpret_cast<const __nv_bfloat162*>(c00 + PATCH_W * S::LDC);
        const __nv_bfloat162* q11 =
            reinterpret_cast<const __nv_bfloat162*>(c00 + PATCH_W * S::LDC + S::LDC);
        __align__(16) __nv_bfloat162 mx[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e] = __hmax2(__hmax2(q00[e], q01[e]), __hmax2(q10[e], q11[e]));
        *reinterpret_cast<uint4*>(
            p.pooled + ((static_cast<size_t>(b) * Hp + y0 / 2 + py) * Wp + x0 / 2 + px) * p.F +
            n0 + sub * 8) = *reinterpret_cast<const uint4*>(mx);
      }
    }
  }
}

template <int TN, int OP, int PH>
cudaError_t launch_conv_tn(const Launch& L, const bf16* in, const bf16* in2, const bf16* wt,
                           const ConvArgs& a, cudaStream_t stream) {
  using S = ConvSmem<TN, PH>;
  CUtensorMap ma, ma2, mw;
  cudaError_t e = make_map(&ma, in, L.map(0));
  if (e != cudaSuccess) return e;
  e = make_map(&mw, wt, L.map(1));
  if (e != cudaSuccess) return e;
  if (L.has_map(2)) {
    if ((e = make_map(&ma2, in2, L.map(2))) != cudaSuccess) return e;
  } else {
    ma2 = ma;  // never read: the K walk has no slice of a second map
  }
  e = cudaFuncSetAttribute(conv_sm90_kernel<TN, OP, PH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::DYN);
  if (e != cudaSuccess) return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  ConvArgs args = a;
  args.tiles = static_cast<int>(L.grid().x);
  const int blocks = S::OWN && args.tiles > sms ? sms : args.tiles;
  conv_sm90_kernel<TN, OP, PH><<<blocks, THREADS, S::DYN, stream>>>(ma, ma2, mw, args);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_conv_op(const Launch& L, const bf16* in, const bf16* in2, const bf16* wt,
                           const ConvArgs& a, cudaStream_t stream) {
  if (L.tile_m() == PATCH) {
    if (L.tile_n() == 256) return launch_conv_tn<256, OP, 8>(L, in, in2, wt, a, stream);
    if (L.tile_n() == 192) return launch_conv_tn<192, OP, 8>(L, in, in2, wt, a, stream);
    if (L.tile_n() == 128) return launch_conv_tn<128, OP, 8>(L, in, in2, wt, a, stream);
    if (L.tile_n() == 64) return launch_conv_tn<64, OP, 8>(L, in, in2, wt, a, stream);
  }
  // the 256-pixel tile: the forwards (pooling or not) and the dgrads of
  // 64- and 128-wide output tiles (a decoder's up1 and up2, VGG16 block 2)
  if (L.tile_m() == 2 * PATCH && L.tile_n() == 128)
    return launch_conv_tn<128, OP, 16>(L, in, in2, wt, a, stream);
  if (L.tile_m() == 2 * PATCH && L.tile_n() == 64)
    return launch_conv_tn<64, OP, 16>(L, in, in2, wt, a, stream);
  return cudaErrorInvalidConfiguration;
}

// One conv per its launch record: `in` (B, H, W, C) bf16 under map 0,
// `wt` (F, 9 (C + C2)) bf16 under map 1 and, where the record has map 2,
// `in2` (B, H, W, C2) bf16 under it (a.C2 > 0 exactly then).  A split
// dgrad's record carries its split S (0 < S <= F, S % 8 == 0; a.out2 set
// where S < F).
inline cudaError_t launch_conv_sm90(const int64_t* record, const bf16* in, const bf16* in2,
                                    const bf16* wt, const ConvArgs& a, cudaStream_t stream) {
  const Launch L{record};
  if (L.has_map(2) != (a.C2 > 0) || (a.C2 > 0 && in2 == nullptr)) return cudaErrorInvalidValue;
  switch (L.op()) {
    case OP_FWD: return launch_conv_op<OP_FWD>(L, in, in2, wt, a, stream);
    case OP_FWD_POOL: return launch_conv_op<OP_FWD_POOL>(L, in, in2, wt, a, stream);
    case OP_DGRAD_MASK: return launch_conv_op<OP_DGRAD_MASK>(L, in, in2, wt, a, stream);
    case OP_DGRAD_SPLIT: {
      const int s = L.split();
      if (s <= 0 || s > a.F || s % 8 || (s < a.F && a.out2 == nullptr))
        return cudaErrorInvalidValue;
      ConvArgs args = a;
      args.split = s;
      return launch_conv_op<OP_DGRAD_SPLIT>(L, in, in2, wt, args, stream);
    }
    default: return cudaErrorInvalidConfiguration;
  }
}

}  // namespace
}  // namespace sm90
}  // namespace tu
