// The halo mainloop: a float32 3x3 SAME conv of TN = 64 output channels a
// tile (a forward's at F % 128 == 0: 128), each 32-channel K slice brought
// as ONE TMA box with its one-pixel halo
// that serves all nine taps.  It runs the up_conv head's four float32 convs
// (csrc/upconv.cu: #10's conv1 and conv2, #12's masked dgrad of conv2 and
// its dgrad of conv1), a UnetUp stage's two float32 convs where its plan
// puts them (csrc/decoder_fuse.cu, #1: conv1 over the two maps [skip |
// up], conv2) and the stem backward's float32 masked dgrad
// (csrc/encoder_train.cu, #20), which the conv core (conv3x3_sm90.cuh) ran
// before.
//
// What it computes is the conv core's, in float32 with TF32 products:
//   out[b, y, x, n] = epi(sum_k A[(b, y, x), k] * Wt[n, k])
// with k = (ky * 3 + kx) * Ct + c, A the NHWC input — one map of C
// channels, or (a forward only) the channel concat [in | in2] of two maps,
// Ct = C + C2, never stored — and Wt the packed weights (F, 9 Ct) of
// pack_weights.cu; epi the conv core's epilogue (conv_epilogue: bias +
// ReLU, the masked dgrad, the split store).
//
// Why: the conv core's float32 K slice is one tap x 32 channels, a 256 x 64
// tile's 32 KB input box and 8 KB weight box for 1.05 MFLOP: 25.6 FLOP a
// byte of L2, each input pixel fetched nine times, once a tap.  At the
// head's shapes the operands stream from L2, whose rate held those convs at
// 33% of the TF32 bound on an H100 (PERF.md).
//
// The K walk is slice-major.  For each 32-channel slice of the input the
// producer issues one 4-D TMA halo box (32 c, 18 x, PH + 2 y, 1 b) at (c0,
// x0 - 1, y0 - 1, b) — TMA's zero fill is the SAME padding, and the
// channels past the map's width — and the slice's nine weight boxes (32 c,
// 1 tap, TN n) of the weights viewed as (F, 9, Ct) at the slice's weight
// channel, one a stage of a ring of nine (TN = 128: four): in's slices
// first (map 0, weight channel c0), then in2's (map 2, weight channel C +
// c0), as the conv core's walk takes them per tap (kernels/sm90.py::
// halo_walk).  At the 16 x 16 x 64 tile a slice is a 41.5 KB halo box and
// 72 KB of weights for 9.44 MFLOP: 82 FLOP a byte of L2, 3.2 times the
// per-tap slice's; at 16 x 16 x 128, 144 KB of weights for 18.9 MFLOP, 100
// FLOP a byte.
//
// Products: each tap is a shift of the halo rows the A fragments read:
// output pixel (y, x) at tap (ky, kx) is halo row (y + ky) * 18 + x + kx,
// 128 bytes (its 32 channels), 128-byte swizzled (16-byte unit u at u ^
// (row % 8)).  A consumer loads a k8 step's m64n64k8 TF32 A fragment with
// one ldmatrix.x4: lanes 8i .. 8i + 7 address 8 consecutive halo rows
// (pixels x .. x + 7, or + 8 for matrices 1 and 3) at the step's first
// 16-byte unit (matrices 0 and 1) or its second (2 and 3), and register i
// of thread t receives word t % 4 of row t / 4 of matrix i: the fragment's
// (row, k t % 4) for a0 / a1 and (row, k t % 4 + 4) for a2 / a3.  8
// consecutive rows cover the 8 residues of the swizzle, so each matrix
// reads 32 distinct banks at any tap shift.  B is the tap's weight box
// through the shared-memory descriptor (K-major, as the conv core reads
// it); wgmma.m64nTNk8 .tf32 with A from registers.
//
// Rounding: a register operand reaches the tensor cores as its word is, so
// the activation is rounded to TF32 (to nearest, ties away: cvt.rna) — once
// an element, in place in the halo box, by the producer warpgroup's warps
// 1-3 before the consumers load their fragments (a fragment rounded a tap
// would pay it nine times an element, which was the float32 weight-gradient
// GEMM's largest cost on an H100); the weights are rounded when packed.
// kernels/tf32.py states that rule for these launches.
//
// Block: 384 threads.  Warpgroups 0 and 1 consume: warpgroup wg the rows
// (PH / 2) wg .. (PH / 2) (wg + 1) - 1 of the PH x 16 tile, PH / 8 m64
// tiles of TN / 2 accumulators a thread (setmaxnreg: 232 registers).  In
// warpgroup 2, thread 0 issues every TMA load (the halo boxes into a ring
// of 2, the weight boxes into their ring: at TN = 64 a slice's tap t in
// stage t; at 128 the block's q-th box, q = 9 slices + tap, in stage q % 4),
// and warps 1-3 round each halo box in place and arrive on its "ready"
// barrier.  Per tap a consumer waits for its products of the tap before
// (which releases that tap's weight stage and frees the fragment
// registers), loads the fragments of its 4 k8 steps, issues its PH / 8 x 4
// products and commits; the other consumer warpgroup's products run while
// it loads.  (A fragment register written while products are in flight —
// one tap's loads overlapping the tap before's products in a warpgroup —
// makes ptxas serialize every wgmma of the kernel (C7513), as a first
// version of this kernel did.)  A slice's halo stage is released after its
// ninth tap's loads.  Persistent: one block an SM walks the tiles (the F /
// TN channel tiles of a patch adjacent), the rings running on across tiles,
// so the next tile's boxes load during the epilogue, the conv core's
// (conv_epilogue), which stages 64 columns at a time (a masked dgrad's in
// chunks of 32: halo_chunk) in shared memory of its own.  The summation
// order is fixed (per tile the slices in order, in each the taps 0-8, in
// each the 4 k8 steps), so a relaunch is bit-identical.
//
// What holds it (an H100, the self_net head's convs, PERF.md): with the
// epilogue left out the mainloop reads 66% of the TF32 bound, the whole
// kernel 46-51%.  Each m64n64k8 product reads 2 KB of A by ldmatrix and 2
// KB of B by its descriptor for 32 cycles of the tensor cores: 128 bytes a
// cycle, the SM's shared-memory rate, before the TMA writes and the
// rounding.  An m64n128k8 product reads 2 KB of A and 4 KB of B in 64
// cycles, 96 bytes a cycle, and each halo box serves 128 channels: at a
// UnetUp stage's F = 128 and 256 its convs read 60-79% of the bound, where
// the 64-wide tile read 54-61% at F = 128 (PERF.md).  Tried and dropped, each no faster or
// slower: a third halo stage (with 16-column epilogue chunks), three taps a
// wait, the consumers rounding their fragments, the tile's stores deferred
// into the next tile's taps.
//
// Bound on the H100: operations (2 * 9 * C * F multiply-adds a pixel at the
// TF32 peak).  The plan (tile, grid, maps) is kernels/sm90.py::
// halo_conv_launch's; its records name this mainloop (Launch::mainloop),
// and each mainloop refuses the other's.  Shapes: H % PH == 0 (PH = 16, or
// 8), W % 16 == 0, C % 8 == 0 and C2 % 8 == 0 (16-byte TMA strides), F % 64
// == 0.
#pragma once

#include "conv3x3_sm90.cuh"

namespace tu {
namespace sm90 {
namespace {

constexpr int HALO_TN = 64;                     // output channels a tile (a forward: or 128)
constexpr int HALO_SL = 32;                     // float32 channels of a slice (128 bytes)
constexpr int HALO_STAGES = 2;                  // halo boxes in flight
constexpr int HALO_ROUNDERS = 96;               // warps 1-3 of the producer warpgroup
// the columns the epilogue stages at a time: the tile's 64, or 32 for a
// masked dgrad, whose second chunk's mask loads then fly during the first
// chunk's stores (on an H100 its conv read 4% faster than with one chunk,
// the others 0-2% slower)
template <int OP>
__host__ __device__ constexpr int halo_chunk() {
  return OP == OP_DGRAD_MASK ? 32 : 64;
}

// the weight ring's stages: a slice's nine taps' boxes (32 c, 1 tap, TN n)
// at TN = 64 (8 KB each; tap t in stage t); at TN = 128 (16 KB) the four
// that fit beside the halo stages and the epilogue's buffer
template <int TN>
__host__ __device__ constexpr int halo_w_stages() {
  return TN == 64 ? 9 : 4;
}

// The weight ring's stage of tap `tap` of a block's g-th slice (the
// block's q-th weight box, q = 9 g + tap: stage q % WS, at WS = 9 the tap)
// and the parity of that stage's use.
struct WSlot {
  int s, ph;
};

template <int WS>
__device__ __forceinline__ WSlot wslot(int g, int tap) {
  if constexpr (WS == 9) {
    return {tap, g & 1};
  } else {
    const int q = 9 * g + tap;
    return {q % WS, (q / WS) & 1};
  }
}

template <int OP, int PH, int TN>
struct HaloSmem {
  static constexpr int M = PH * PATCH_W;                     // pixels of the tile
  static constexpr int HW = PATCH_W + 2, HH = PH + 2;        // the halo box: 18 x (PH + 2)
  static constexpr int BOX = HW * HH * 128;                  // 41,472 bytes at PH = 16
  static constexpr int SLOT = (BOX + 1023) / 1024 * 1024;    // 1024-aligned for the swizzle
  static constexpr int TAP_BYTES = TN * 128;                 // a tap's weight box
  static constexpr int W_STAGES = halo_w_stages<TN>();
  static constexpr int W_OFF = HALO_STAGES * SLOT;
  static constexpr int OUT_OFF = W_OFF + W_STAGES * TAP_BYTES;
  static constexpr int LDC = halo_chunk<OP>() + 4;           // staging row (floats)
  static constexpr int OUT_BYTES = M * LDC * 4;
  static constexpr int BAR_OFF = OUT_OFF + OUT_BYTES;
  static constexpr int BARS = 3 * HALO_STAGES + 2 * W_STAGES;
  static constexpr int DYN = BAR_OFF + 8 * BARS + 1024;     // + 1024 as sm90.py counts
  static_assert(DYN <= SMEM_MAX && W_OFF % 1024 == 0 && OUT_OFF % 1024 == 0, "the rings fit");
};

template <int OP, int PH, int TN>
__global__ void __launch_bounds__(THREADS, 1)
halo_conv_kernel(const __grid_constant__ CUtensorMap act, const __grid_constant__ CUtensorMap act2,
                 const __grid_constant__ CUtensorMap wmap, ConvArgsT<float> p) {
  using S = HaloSmem<OP, PH, TN>;
  constexpr int MT = PH / 8;  // m64 tiles of a consumer warpgroup
  constexpr int WS = S::W_STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  float* sc = reinterpret_cast<float*>(smem + S::OUT_OFF);
  uint64_t* hfull = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* hready = hfull + HALO_STAGES;
  uint64_t* hempty = hready + HALO_STAGES;
  uint64_t* wfull = hempty + HALO_STAGES;
  uint64_t* wempty = wfull + WS;
  const int tid = threadIdx.x;
  const int ns0 = (p.C + HALO_SL - 1) / HALO_SL;           // slices of in
  const int ns = ns0 + (p.C2 + HALO_SL - 1) / HALO_SL;  // ... and of in2: a tile's

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < HALO_STAGES; ++s) {
      mbar_init(&hfull[s], 1);
      mbar_init(&hready[s], HALO_ROUNDERS);
      mbar_init(&hempty[s], CONSUMERS);
    }
#pragma unroll
    for (int s = 0; s < WS; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Block i takes tiles i, i + gridDim.x, ...; g counts the block's slices:
  // slice g's halo box in stage g % 2, its tap t's weights in stage
  // wslot(g, t).s (at TN = 64 stage t).
  if (tid >= CONSUMERS) {
    producer_regs();
    const int pt = tid - CONSUMERS;
    if (pt == 0) {  // every TMA load
      int g = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile T_ = tile_of<TN, PH>(t, p);
        for (int j = 0; j < ns; ++j, ++g) {
          const int hs = g % HALO_STAGES;
          const bool first = j < ns0;  // a slice of in, else of in2
          const int c0 = (first ? j : j - ns0) * HALO_SL;
          if (g >= HALO_STAGES) mbar_wait(&hempty[hs], ((g / HALO_STAGES) - 1) & 1);
          mbar_expect_tx(&hfull[hs], S::BOX);
          tma_load_4d(smem + hs * S::SLOT, first ? &act : &act2, &hfull[hs], c0, T_.x0 - 1,
                      T_.y0 - 1, T_.b);
          for (int tap = 0; tap < 9; ++tap) {
            const WSlot w = wslot<WS>(g, tap);
            if (9 * g + tap >= WS) mbar_wait(&wempty[w.s], w.ph ^ 1);
            mbar_expect_tx(&wfull[w.s], S::TAP_BYTES);
            tma_load_3d(smem + S::W_OFF + w.s * S::TAP_BYTES, &wmap, &wfull[w.s],
                        first ? c0 : p.C + c0, tap, T_.n0);
          }
        }
      }
    } else if (pt >= 32) {  // round each halo box to TF32 in place, 16 bytes a thread at a time
      const int rt = pt - 32;
      int g = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x)
        for (int j = 0; j < ns; ++j, ++g) {
          const int hs = g % HALO_STAGES;
          mbar_wait(&hfull[hs], (g / HALO_STAGES) & 1);
          uint4* hb = reinterpret_cast<uint4*>(smem + hs * S::SLOT);
#pragma unroll 3
          for (int i = rt; i < S::BOX / 16; i += HALO_ROUNDERS) {
            const float4 h = *reinterpret_cast<const float4*>(hb + i);
            hb[i] = make_uint4(to_tf32(h.x), to_tf32(h.y), to_tf32(h.z), to_tf32(h.w));
          }
          fence_proxy_async();  // before the slot's next TMA write
          mbar_arrive(&hready[hs]);
        }
    }
    return;
  }

  consumer_regs();
  const int wg = tid >> 7, v = (tid >> 5) & 3, lane = tid & 31;
  // the ldmatrix row this lane addresses: matrix lane / 8, its row lane % 8
  // (pixel x of the fragment's rows; matrices 1 and 3 the rows + 8, x + 8),
  // its 16-byte unit of the k8 step (matrices 2 and 3 the second)
  const int mx = (lane & 7) + 8 * ((lane >> 3) & 1), mu = lane >> 4;
  int hrow[MT];  // the halo row of tap (0, 0) of m64 tile i: pixel ((PH / 2) wg + 4 i + v, mx)
#pragma unroll
  for (int i = 0; i < MT; ++i) hrow[i] = ((PH / 2) * wg + 4 * i + v) * S::HW + mx;
  uint32_t fr[MT][4][4];  // a tap's fragments: (m64 tile, k8 step, register)
  int g = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile T_ = tile_of<TN, PH>(t, p);
    float acc[MT][TN / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < TN / 2; ++c) acc[i][c] = 0.f;
    for (int j = 0; j < ns; ++j, ++g) {
      const int hs = g % HALO_STAGES, ph = (g / HALO_STAGES) & 1;
      mbar_wait(&hfull[hs], ph);
      mbar_wait(&hready[hs], ph);
      const uint8_t* halo = smem + hs * S::SLOT;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const WSlot w = wslot<WS>(g, tap);
        mbar_wait(&wfull[w.s], w.ph);
        wgmma_wait<0>();  // the tap before is done: its weight stage and the fragments are free
        if (tap > 0)
          mbar_arrive(&wempty[wslot<WS>(g, tap - 1).s]);
        else if (j > 0)
          mbar_arrive(&wempty[wslot<WS>(g - 1, 8).s]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = hrow[i] + ky * S::HW + kx;
          const uint8_t* row = halo + r * 128;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            fence_regs(fr[i][s]);  // kept until the products that read them are done
            ldmatrix_x4(row + (((2 * s + mu) ^ (r & 7)) << 4), fr[i][s]);
          }
        }
        const uint64_t db = desc_sw128(smem + S::W_OFF + w.s * S::TAP_BYTES, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int s = 0; s < 4; ++s) wgmma_tf32_rs<TN>(acc[i], fr[i][s], db + 2 * s);
        wgmma_commit();
      }
      mbar_arrive(&hempty[hs]);  // the slice's fragments are loaded
    }
    wgmma_wait<0>();
    mbar_arrive(&wempty[wslot<WS>(g - 1, 8).s]);  // the tile's last tap
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
    conv_epilogue<float, TN, OP, PH, halo_chunk<OP>()>(acc, p, T_, sc, tid);
  }
}

template <int OP, int PH, int TN>
cudaError_t launch_halo_tn(const Launch& L, const float* in, const float* in2, const float* wt,
                           const ConvArgsT<float>& a, cudaStream_t stream) {
  using S = HaloSmem<OP, PH, TN>;
  const int64_t *hm = L.map(0), *wm = L.map(1), *hm2 = L.map(2);
  auto halo_box = [&](const int64_t* m) {
    return m[8] == HALO_SL && m[9] == S::HW && m[10] == S::HH && m[11] == 1;
  };
  if (!halo_box(hm) || (L.has_map(2) && !halo_box(hm2)) || wm[8] != HALO_SL || wm[9] != 1 ||
      wm[10] != TN)
    return cudaErrorInvalidConfiguration;
  CUtensorMap ma, ma2, mw;
  cudaError_t e = make_map(&ma, in, hm, true);
  if (e != cudaSuccess) return e;
  if ((e = make_map(&mw, wt, wm, true)) != cudaSuccess) return e;
  if (L.has_map(2)) {
    if ((e = make_map(&ma2, in2, hm2, true)) != cudaSuccess) return e;
  } else {
    ma2 = ma;  // never read: the K walk has no slice of a second map
  }
  e = cudaFuncSetAttribute(halo_conv_kernel<OP, PH, TN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::DYN);
  if (e != cudaSuccess) return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  ConvArgsT<float> args = a;
  args.tiles = static_cast<int>(L.grid().x);
  const int blocks = args.tiles > sms ? sms : args.tiles;
  halo_conv_kernel<OP, PH, TN><<<blocks, THREADS, S::DYN, stream>>>(ma, ma2, mw, args);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_halo_op(const Launch& L, const float* in, const float* in2, const float* wt,
                           const ConvArgsT<float>& a, cudaStream_t stream) {
  if (L.tile_n() == HALO_TN) {
    if (L.tile_m() == 2 * PATCH) return launch_halo_tn<OP, 16, 64>(L, in, in2, wt, a, stream);
    if (L.tile_m() == PATCH) return launch_halo_tn<OP, 8, 64>(L, in, in2, wt, a, stream);
  }
  if constexpr (OP == OP_FWD) {  // the 128-wide tile: forwards only
    if (L.tile_n() == 2 * HALO_TN) {
      if (L.tile_m() == 2 * PATCH) return launch_halo_tn<OP, 16, 128>(L, in, in2, wt, a, stream);
      if (L.tile_m() == PATCH) return launch_halo_tn<OP, 8, 128>(L, in, in2, wt, a, stream);
    }
  }
  return cudaErrorInvalidConfiguration;
}

// One float32 conv per its launch record, which must name the halo mainloop
// (a record of the conv core's, or of bf16, is refused): `in` (B, H, W, C)
// under map 0 (the halo box), `wt` (F, 9 (C + C2)) under map 1 and, where
// the record has map 2 (OP_FWD only), `in2` (B, H, W, C2) under it (a.C2 >
// 0 exactly then); OP_FWD, OP_DGRAD_MASK or OP_DGRAD_SPLIT (its split from
// the record, as the conv core takes it).
cudaError_t launch_halo_conv_sm90(const int64_t* record, const float* in, const float* in2,
                                  const float* wt, const ConvArgsT<float>& a,
                                  cudaStream_t stream) {
  const Launch L{record};
  if (!L.f32() || L.mainloop() != MAINLOOP_HALO || L.has_map(2) != (a.C2 > 0) ||
      (a.C2 > 0 && (in2 == nullptr || L.op() != OP_FWD)))
    return cudaErrorInvalidValue;
  switch (L.op()) {
    case OP_FWD: return launch_halo_op<OP_FWD>(L, in, in2, wt, a, stream);
    case OP_DGRAD_MASK: return launch_halo_op<OP_DGRAD_MASK>(L, in, in2, wt, a, stream);
    case OP_DGRAD_SPLIT: {
      const int s = L.split();
      if (s <= 0 || s > a.F || s % 8 || (s < a.F && a.out2 == nullptr))
        return cudaErrorInvalidValue;
      ConvArgsT<float> args = a;
      args.split = s;
      return launch_halo_op<OP_DGRAD_SPLIT>(L, in, in2, wt, args, stream);
    }
    default: return cudaErrorInvalidConfiguration;
  }
}

// One float32 or bf16 conv per its launch record, on the mainloop the
// record names (its word 9): the halo mainloop (float32 only) or the conv
// core, each refusing the other's records, so a bf16 record that names the
// halo mainloop is refused by the core.
template <typename T>
cudaError_t launch_conv_record(const int64_t* record, const T* in, const T* in2, const T* wt,
                               const ConvArgsT<T>& a, cudaStream_t stream) {
  if constexpr (is_f32<T>()) {
    if (Launch{record}.mainloop() == MAINLOOP_HALO)
      return launch_halo_conv_sm90(record, in, in2, wt, a, stream);
  }
  return launch_conv_sm90<T>(record, in, in2, wt, a, stream);
}

}  // namespace
}  // namespace sm90
}  // namespace tu
