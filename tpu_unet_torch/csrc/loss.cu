// final_ce_dice: the final 1x1 classifier fused into the training loss —
// weighted cross-entropy (ignore class C, mean by the weight sum) + soft
// dice (beta 1) + the f_score metric at threshold 0.5 — and its gradient.
//
// Replaces tpu_unet/kernels/loss.py::_final_fwd_impl (the Pallas call at
// loss.py:704) with tu_final_ce_dice_fwd and ::_final_vjp_bwd (:804) with
// tu_final_ce_dice_bwd.  As on the TPU, the (pixels, C) logit map never
// reaches device memory: each pass reads the (pixels, 64) feature map once
// and recomputes the logits per pixel.
//
//   forward:  per pixel x = round_T(round_T(f . W[c]) + b[c]) (f32 sums,
//             rounded to the feature dtype T, bias added in T, as nn.Conv
//             does it), softmax, and the global sums
//             [sum w*nll, sum w, tp[C], psum[C], tsum[C], tp@0.5[C],
//              pos@0.5[C]]  (w = cls_weight[t] for t < C, else 0; an
//             ignored pixel counts in psum and pos@0.5, a pixel past n
//             nowhere, as in _reduce_body); then, on the device, the loss,
//             f_score and the residuals (s_w, denom[C], score[C]) of
//             _finish (kernels/loss.py)
//   backward: from the residuals and the loss cotangent gl, on the device,
//             A[c], B[c] (dice_coefs) and inv = gl / max(s_w, 1e-12); then
//             dlog = w*(p - onehot)*inv + p*((A*onehot + B) - sum_c (A*onehot + B)*p)
//             dfeat = round_T(dlog . W), and the sums dW = f^T dlog (C, 64)
//             and db = sum dlog, f32 (or rounded to bf16 for bf16 weights).
//
// Bound on the H100 at 8 x 512^2 pixels, 64 bf16 features, 21 classes:
// bytes (forward 270.5 MB: 0.081 ms at 3.35 TB/s; backward 539 MB, 0.161
// ms); the products (16.9 GFLOP in the backward) take ~0.02 ms on the
// tensor cores, 0.25 on the float32 pipes, so they run on wgmma.
//
// Design (one template, two kernels): a persistent grid of at most CTAS
// blocks, a constant, so the pixels of each block's partial sums depend
// on n only; block i takes the 128-pixel tiles i, i + grid, ...  A block
// is three warpgroups: warpgroup 2's first thread issues TMA loads of each
// tile (128 pixels x 64 features from a 2-D tensor map over (n, 64): bf16
// rows of 128 bytes land 128-byte swizzled, the layout wgmma reads; f32
// rows of 256 bytes unswizzled) and of its 128 target bytes (a 1-D map)
// into a ring of STAGES stages (6 of 16 KB for bf16; mbarriers full /
// empty).  Warpgroups 0 and 1 each take 64 pixels of a tile:
//   logits   x = F . W^T on wgmma m64nNPk16, NP = C rounded up to 16, 32,
//            64 or 128; W staged once a block as the B operand (NP rows of
//            64 bf16, zero past C, swizzled as TMA would), the bias added
//            in registers (bf16x2: one rounding of the exact sum, as float
//            then bf16 gives for two bf16 values; -inf for a padded
//            column); the row max and sum by shuffles within the quad of
//            threads that holds a row of the m64 fragment.
//   forward  the per-class sums (psum, tp, and at NP <= 64 the counts
//            tsum, tp@0.5, pos@0.5, exact in float) in registers over the
//            columns a thread holds; at NP = 128, where registers run
//            short, the counts by shared-memory integer atomics (exact,
//            order-free); the stage is released once the logits are in.
//   backward dlog in registers, split hi = bf16(dlog), lo = bf16(dlog -
//            hi) (dlog to ~2^-16 relative; one bf16 dlog would be 2^-9);
//            dfeat = dlog . W on wgmma with dlog fed from registers (the
//            float32 accumulator's layout is the A fragment's), rounded to
//            T, staged by stmatrix as a TMA box and stored by TMA (rows
//            past n clipped); dW += F^T . dlog on wgmma (A = the feature
//            tile in the ring, MN-major; B = dlog^T, written by
//            stmatrix.trans) accumulated in registers across the block's
//            tiles; db in registers.
// The softmax takes one exp an element: p = exp(x - max) * rcp(sum), nll
// = log(sum) + max - x[t] (the plain version's log_softmax, to float32
// rounding).
// Float32 features are split the same way (F and W into bf16 hi and lo
// pieces in shared memory): three products, hi.hi + hi.lo + lo.hi.  Rows
// past n (TMA's zero fill) are masked by their index.  At the end a block
// reduces its partials in a fixed order (shuffles, then warps in order)
// into its row of `partial`; the last block to finish, found by an integer
// ticket after __threadfence(), adds the rows in row order and runs the
// scalar epilogue (both in loss_common.cuh, shared with #25 / #26).  No
// float atomics: every result is the same on every run.
//
// On an H100 at the shape above: 0.165 ms forward (49% of its bound),
// 0.263 backward (61%).  The rings alone stream at 83% of the bound and
// the products are nearly free, so the softmax's instructions a logit
// bound both passes.
//
// Targets are one byte a pixel, as the TPU kernel's int8 targets: C <= 126
// and the raw 255 border fit; a value >= C is the ignore class.
// Limits: 64 features, 1 <= C <= 126.
#include "loss_common.cuh"

namespace {

using namespace tu::sm90;
using namespace tu::loss;
using bf16 = __nv_bfloat16;

constexpr int CF = 64;            // features
constexpr int TILE = 128;         // pixels a tile: 64 a consumer warpgroup
constexpr int CTAS = 132;         // the most blocks of a pass (partial rows)
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = 384;      // and one producer warpgroup
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory, 227 KB
constexpr int MAX_STAGES = 6;
constexpr int SMALL = 4096;       // per-class constants, counters, scalars

// Shared memory of a pass (kernels/loss.py::final_loss_plan mirrors it):
// the ring's feature tiles, W (hi and, for f32, lo), the backward's dlog^T
// tiles (hi, lo per warpgroup) and dfeat boxes, the ring's target bytes,
// SMALL, the barriers; as many stages as fit, at most MAX_STAGES.
template <typename T, int NP, bool BWD>
struct Layout {
  static constexpr bool SPLIT = sizeof(T) == 4;
  static constexpr int FT = TILE * CF * static_cast<int>(sizeof(T));
  static constexpr int WT = NP * 128;  // a bf16 tile of NP rows of 64
  static constexpr int W_BYTES = (SPLIT ? 2 : 1) * WT;
  static constexpr int D_BYTES = BWD ? 4 * WT : 0;
  static constexpr int LDO = CF * static_cast<int>(sizeof(T));  // dfeat staging row
  static constexpr int O_BYTES = BWD ? 2 * 64 * LDO : 0;       // the TMA store's boxes
  static constexpr int FIXED = W_BYTES + D_BYTES + O_BYTES + SMALL + 1024;
  static constexpr int PER_STAGE = FT + TILE + 16;
  static constexpr int FIT = (SMEM_MAX - FIXED) / PER_STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int W_OFF = STAGES * FT;
  static constexpr int D_OFF = W_OFF + W_BYTES;
  static constexpr int O_OFF = D_OFF + D_BYTES;
  static constexpr int T_OFF = O_OFF + O_BYTES;
  static constexpr int S_OFF = T_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = S_OFF + SMALL;
  static constexpr int DYN = FIXED + STAGES * PER_STAGE;
  static_assert(STAGES >= 2 && BAR_OFF + 16 * STAGES + 1024 == DYN && DYN <= SMEM_MAX,
                "the ring fits");
  // the end-of-block reductions reuse the ring
  static_assert(STAGES * FT >= 4 * (64 * NP + 40 * NP + 64), "the scratch fits the ring");
};

// SMALL, in floats: bias[128], cw[128], A[128], B[128], the forward's
// counts (int) ts[128], tpt[128], pts[128] (at NP = 128) or the backward's
// A + B[128], the scalars inv and the last-block flag, the bias as bf16
constexpr int S_BIAS = 0, S_CW = 128, S_A = 256, S_B = 384, S_TS = 512, S_TPT = 640,
              S_PTS = 768, S_INV = 896, S_LAST = 897;
constexpr int S_AB = S_TS;  // the backward's A + B (it keeps no counts)
constexpr int S_BB = 960;   // the bias as bf16 (128 of them in 64 floats)
constexpr int NO_CLASS = 1024;  // the target of an ignored pixel or a row past n

struct Args {
  const void* wt;     // (C, 64) in the feature dtype
  const void* bias;   // (C) in the feature dtype
  const float* cw;    // (C) class weights
  float* partial;     // (grid, row)
  unsigned* ticket;   // 0 before a pass; the last block sets it back to 0
  long long n;
  int C, with_dice;
  // forward: loss, f_score and res = [s_w, denom[C], score[C], sums[2 + 5C]]
  float* loss;
  float* fscore;
  float* res;
  // backward
  const float* gl;
  const float* s_w;
  const float* denom;
  const float* score;
  void* dfeat;        // (n, 64) in the feature dtype
  void* dw;           // (C, 64), bf16 with grad_bf16, else f32
  void* db;           // (C), likewise
  float* coefs;       // [A[C], B[C], inv]
  int grad_bf16;
};

// element i of a (C, 64) or (C) parameter in the feature dtype
template <typename T>
__device__ __forceinline__ float param_at(const void* p, int i) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
  else
    return static_cast<const float*>(p)[i];
}

// byte offset of element (r, k) of a 128-byte-swizzled tile of 64-wide
// bf16 rows (its base 1024-byte aligned): chunk k / 8 of row r sits at
// chunk (k / 8) ^ (r % 8), as TMA writes CU_TENSOR_MAP_SWIZZLE_128B
__device__ __forceinline__ int sw128(int r, int k) {
  return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + ((k & 7) << 1);
}

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// over the 8 lanes that hold the same columns (lane % 4 equal)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The body of both passes (a kernel each, so a profile names them apart).
template <typename T, int NP, bool BWD>
__device__ __forceinline__ void final_loss_body(const CUtensorMap* fmap, const CUtensorMap* tmap,
                                                const CUtensorMap* omap, const Args& a) {
  using L = Layout<T, NP, BWD>;
  constexpr int NA = NP / 2;  // accumulators of an m64nNP product a thread
  extern __shared__ __align__(1024) uint8_t smem[];
  float* sm = reinterpret_cast<float*>(smem + L::S_OFF);
  int* si = reinterpret_cast<int*>(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint8_t* Wh = smem + L::W_OFF;
  uint8_t* Wl = Wh + L::WT;  // f32 features only
  bf16* bb = reinterpret_cast<bf16*>(sm + S_BB);
  const int tid = threadIdx.x, C = a.C;
  const long long n = a.n, ntiles = (n + TILE - 1) / TILE;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  if (tid < CONSUMERS) {
    // W as the B operand: NP rows of 64 bf16 (hi, and lo for f32), zero past C
    for (int i = tid; i < NP * CF; i += CONSUMERS) {
      const int c = i / CF, k = i - c * CF;
      const float v = c < C ? param_at<T>(a.wt, i) : 0.f;
      const bf16 h = __float2bfloat16_rn(v);
      *reinterpret_cast<bf16*>(Wh + sw128(c, k)) = h;
      if constexpr (L::SPLIT)
        *reinterpret_cast<bf16*>(Wl + sw128(c, k)) = __float2bfloat16_rn(v - __bfloat162float(h));
    }
    if (tid < 128) {
      const bool real = tid < C;
      const float bias = real ? param_at<T>(a.bias, tid) : -INFINITY;
      sm[S_BIAS + tid] = bias;
      bb[tid] = __float2bfloat16_rn(bias);
      sm[S_CW + tid] = real ? a.cw[tid] : 0.f;
      si[S_TS + tid] = 0;
      si[S_TPT + tid] = 0;
      si[S_PTS + tid] = 0;
      if constexpr (BWD) {
        // dice_coefs and _inv (kernels/loss.py), the same float32 operations
        const float g = *a.gl;
        float ca = 0.f, cb = 0.f;
        if (real && a.with_dice) dice_coef(g, a.denom[tid], a.score[tid], C, ca, cb);
        sm[S_A + tid] = ca;
        sm[S_B + tid] = cb;
        sm[S_AB + tid] = ca + cb;
        if (tid == 0) sm[S_INV] = g / fmaxf(*a.s_w, 1e-12f);
      }
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == CONSUMERS) {
      int it = 0;
      for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
        const int s = it % L::STAGES;
        if (it >= L::STAGES) mbar_wait(&empty[s], ((it / L::STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], L::FT + TILE);
        const int p0 = static_cast<int>(tile * TILE);
        tma_load_2d(smem + s * L::FT, fmap, &full[s], 0, p0);
        tma_load_1d(smem + L::T_OFF + s * TILE, tmap, &full[s], p0);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = tid >> 7, lt = tid & 127, warp = lt >> 5, lane = tid & 31;
  const int q = lane & 3, lr = warp * 16 + (lane >> 2);  // rows lr, lr + 8 of the warpgroup's 64
  const float inv = BWD ? sm[S_INV] : 0.f;
  const uint64_t dwh = desc_sw128(Wh, 16, 1024);
  [[maybe_unused]] const uint64_t dwl = desc_sw128(Wl, 16, 1024);

  // forward sums (the counts in registers too at NP <= 64, else by
  // shared-memory atomics) / backward accumulators
  constexpr bool RC = NP <= 64;
  [[maybe_unused]] float ps[NP / 4], tp[NP / 4], s_wnll = 0.f, s_w = 0.f;
  [[maybe_unused]] float ts[RC ? NP / 4 : 1], tpt[RC ? NP / 4 : 1], pts[RC ? NP / 4 : 1];
  [[maybe_unused]] float dw[NA], db[NP / 4];
#pragma unroll
  for (int i = 0; i < NP / 4; ++i) ps[i] = tp[i] = db[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (RC ? NP / 4 : 1); ++i) ts[i] = tpt[i] = pts[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NA; ++i) dw[i] = 0.f;

  int it = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int s = it % L::STAGES;
    mbar_wait(&full[s], (it / L::STAGES) & 1);
    uint8_t* fa = smem + s * L::FT + wg * (L::FT / 2);  // this warpgroup's 64 rows
    const uint8_t* tg = smem + L::T_OFF + s * TILE + wg * 64;
    const long long pr = tile * TILE + wg * 64 + lr;
    const bool v0 = pr < n, v1 = pr + 8 < n;
    // the rows' targets; an ignored pixel (t >= C) and a row past n take
    // NO_CLASS, which matches no column
    const int g0 = tg[lr], g1 = tg[lr + 8];
    const int t0 = v0 && g0 < C ? g0 : NO_CLASS, t1 = v1 && g1 < C ? g1 : NO_CLASS;

    if constexpr (L::SPLIT) {
      // f32 rows (256 bytes) -> bf16 hi and lo tiles, swizzled, in place
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = reinterpret_cast<const float4*>(fa)[lt + 128 * i];
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ch = lt + 128 * i, r = ch >> 4, k = (ch & 15) << 2;
        const float f[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
        bf16 h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = __float2bfloat16_rn(f[e]);
          l[e] = __float2bfloat16_rn(f[e] - __bfloat162float(h[e]));
        }
        *reinterpret_cast<uint2*>(fa + sw128(r, k)) = make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
        *reinterpret_cast<uint2*>(fa + 8192 + sw128(r, k)) =
            make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
    }

    // x = F . W^T (+ the split's cross terms)
    float x[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) x[i] = 0.f;
    const uint64_t dfa = desc_sw128(fa, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < CF / 16; ++k) wgmma<NP, 0, 0>(x, dfa + 2 * k, dwh + 2 * k, k > 0);
    if constexpr (L::SPLIT) {
      const uint64_t dfl = desc_sw128(fa + 8192, 16, 1024);
#pragma unroll
      for (int k = 0; k < CF / 16; ++k) wgmma<NP, 0, 0>(x, dfa + 2 * k, dwl + 2 * k, 1);
#pragma unroll
      for (int k = 0; k < CF / 16; ++k) wgmma<NP, 0, 0>(x, dfl + 2 * k, dwh + 2 * k, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(x);
    if constexpr (!BWD) mbar_arrive(&empty[s]);  // the forward is done with the stage

    // logits as the plain version rounds them, round_T(round_T(acc) + b),
    // for the two columns c, c + 1 a thread holds at once (bf16x2: the add
    // rounds the exact sum once, as float then bf16 does for two bf16
    // values); a padded column's bias is -inf.  x[4j + e]: row lr, column
    // 8j + 2q + e; x[4j + 2 + e]: row lr + 8
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int c = 8 * j + 2 * q;
      if constexpr (L::SPLIT) {
        const float b0 = sm[S_BIAS + c], b1 = sm[S_BIAS + c + 1];
        x[4 * j] += b0;
        x[4 * j + 1] += b1;
        x[4 * j + 2] += b0;
        x[4 * j + 3] += b1;
      } else {
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bb + c);
        const __nv_bfloat162 y0 = __hadd2(__floats2bfloat162_rn(x[4 * j], x[4 * j + 1]), b2);
        const __nv_bfloat162 y1 = __hadd2(__floats2bfloat162_rn(x[4 * j + 2], x[4 * j + 3]), b2);
        x[4 * j] = __low2float(y0);
        x[4 * j + 1] = __high2float(y0);
        x[4 * j + 2] = __low2float(y1);
        x[4 * j + 3] = __high2float(y1);
      }
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m0 = fmaxf(m0, x[4 * j + e]);
        m1 = fmaxf(m1, x[4 * j + 2 + e]);
      }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    // e = 2^((x - max) log2 e) in place (1 exactly at the max, 0 for a
    // padded column), the row sums by the quad, p = e / sum (0 on a row
    // past n); the target's slot 8j + e where this thread holds it (d0 ==
    // 8j + e) and its logit
    const int d0 = t0 - 2 * q, d1 = t1 - 2 * q;
    float e0 = 0.f, e1 = 0.f, xt0 = 0.f, xt1 = 0.f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (d0 == 8 * j + e) xt0 = x[4 * j + e];
        if (d1 == 8 * j + e) xt1 = x[4 * j + 2 + e];
        x[4 * j + e] = ex2((x[4 * j + e] - m0) * LOG2E);
        x[4 * j + 2 + e] = ex2((x[4 * j + 2 + e] - m1) * LOG2E);
        e0 += x[4 * j + e];
        e1 += x[4 * j + 2 + e];
      }
    e0 = quad_sum(e0);
    e1 = quad_sum(e1);
    const float r0 = v0 ? __frcp_rn(e0) : 0.f, r1 = v1 ? __frcp_rn(e1) : 0.f;
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      x[i] *= r0;
      x[i + 1] *= r0;
      x[i + 2] *= r1;
      x[i + 3] *= r1;
    }
    // this thread holds the row's target column (t < C)
    const bool own0 = t0 < C && ((t0 & 7) >> 1) == q, own1 = t1 < C && ((t1 & 7) >> 1) == q;

    if constexpr (!BWD) {
      float pt0 = 0.f, pt1 = 0.f;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e;
          const float p0 = x[4 * j + e], p1 = x[4 * j + 2 + e];
          const bool h0 = d0 == 8 * j + e, h1 = d1 == 8 * j + e;
          ps[i] += p0;
          ps[i] += p1;
          if (h0) tp[i] += p0, pt0 = p0;
          if (h1) tp[i] += p1, pt1 = p1;
          if constexpr (RC) {
            if (h0) ts[i] += 1.f;
            if (h1) ts[i] += 1.f;
            if (h0 && p0 > 0.5f) tpt[i] += 1.f;
            if (h1 && p1 > 0.5f) tpt[i] += 1.f;
            if (p0 > 0.5f) pts[i] += 1.f;
            if (p1 > 0.5f) pts[i] += 1.f;
          } else {
            const int c = 8 * j + 2 * q + e;
            if (p0 > 0.5f) atomicAdd(&si[S_PTS + c], 1);
            if (p1 > 0.5f) atomicAdd(&si[S_PTS + c], 1);
          }
        }
      // the row's weighted nll log(sum) + max - x[t], by its owner
      if (own0) {
        const float w = sm[S_CW + t0];
        s_wnll += w * (logf(e0) + m0 - xt0);
        s_w += w;
        if constexpr (!RC) {
          atomicAdd(&si[S_TS + t0], 1);
          if (pt0 > 0.5f) atomicAdd(&si[S_TPT + t0], 1);
        }
      }
      if (own1) {
        const float w = sm[S_CW + t1];
        s_wnll += w * (logf(e1) + m1 - xt1);
        s_w += w;
        if constexpr (!RC) {
          atomicAdd(&si[S_TS + t1], 1);
          if (pt1 > 0.5f) atomicAdd(&si[S_TPT + t1], 1);
        }
      }
    } else {
      // dlog (_dlogits) = (p - onehot) w inv + p (A onehot + B - inner);
      // 0 on a row past n (p = 0, no target); the inner sums by the quad
      float in0 = 0.f, in1 = 0.f;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          const float bc = sm[S_B + c], abc = sm[S_AB + c];
          in0 += (d0 == 8 * j + e ? abc : bc) * x[4 * j + e];
          in1 += (d1 == 8 * j + e ? abc : bc) * x[4 * j + 2 + e];
        }
      in0 = quad_sum(in0);
      in1 = quad_sum(in1);
      const float wi0 = (t0 < C ? sm[S_CW + t0] : 0.f) * inv;
      const float wi1 = (t1 < C ? sm[S_CW + t1] : 0.f) * inv;
      uint8_t* dth = smem + L::D_OFF + wg * 2 * L::WT;  // dlog^T: NP rows of 64 pixels
      uint8_t* dtl = dth + L::WT;
      uint32_t ah[NP / 4], al[NP / 4];
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          const float bc = sm[S_B + c], abc = sm[S_AB + c];
          const bool h0 = d0 == 8 * j + e, h1 = d1 == 8 * j + e;
          const float p0 = x[4 * j + e], p1 = x[4 * j + 2 + e];
          d[e] = (h0 ? p0 - 1.f : p0) * wi0 + p0 * ((h0 ? abc : bc) - in0);
          d[2 + e] = (h1 ? p1 - 1.f : p1) * wi1 + p1 * ((h1 ? abc : bc) - in1);
          db[2 * j + e] += d[e];
          db[2 * j + e] += d[2 + e];
        }
        // hi / lo pairs: A-fragment registers 2j (row lr) and 2j + 1 (row lr + 8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * r], d[2 * r + 1]);
          const __nv_bfloat162 l =
              __floats2bfloat162_rn(d[2 * r] - __low2float(h), d[2 * r + 1] - __high2float(h));
          ah[2 * j + r] = *reinterpret_cast<const uint32_t*>(&h);
          al[2 * j + r] = *reinterpret_cast<const uint32_t*>(&l);
        }
      }
      // dlog^T (classes x the warpgroup's 64 pixels) by stmatrix.trans: the
      // four 8 x 8 matrices of registers 4jj .. 4jj + 3 are classes 16jj +
      // {0-7, 0-7, 8-15, 8-15} x this warp's pixels {0-7, 8-15, 0-7, 8-15};
      // lane 8i + k stores class row 16jj + 8 (i / 2) + k, its 16-byte
      // chunk of 8 pixels 2 warp + i % 2, swizzled
      {
        const int i = lane >> 3, k = lane & 7;
        const int off = ((i >> 1) * 8 + k) * 128 + ((((2 * warp + (i & 1)) ^ k) & 7) << 4);
#pragma unroll
        for (int jj = 0; jj < NP / 16; ++jj) {
          stmatrix_x4_trans(dth + jj * 2048 + off, ah[4 * jj], ah[4 * jj + 1], ah[4 * jj + 2],
                            ah[4 * jj + 3]);
          stmatrix_x4_trans(dtl + jj * 2048 + off, al[4 * jj], al[4 * jj + 1], al[4 * jj + 2],
                            al[4 * jj + 3]);
        }
      }
      fence_proxy_async();
      if (lt == 0) bulk_wait_read<0>();  // the last tile's dfeat box is read
      bar_sync(1 + wg, 128);  // dlog^T is whole; the dfeat box is free

      // dfeat = dlog . W (A from registers; W as an N-major B: K = classes);
      // dW += F^T . dlog (A = the feature tile, M-major; B = dlog^T)
      float df[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) df[i] = 0.f;
      const uint64_t dwn = desc_sw128(Wh, L::WT, 1024);
      const uint64_t dfm = desc_sw128(fa, L::FT / 2, 1024);
      const uint64_t ddh = desc_sw128(dth, 16, 1024), ddl = desc_sw128(dtl, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        wgmma_m64n64_rs<1>(df, ah + 4 * kk, dwn + 128 * kk, kk > 0);
        wgmma_m64n64_rs<1>(df, al + 4 * kk, dwn + 128 * kk, 1);
      }
      if constexpr (L::SPLIT) {
        const uint64_t dwln = desc_sw128(Wl, L::WT, 1024);
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) wgmma_m64n64_rs<1>(df, ah + 4 * kk, dwln + 128 * kk, 1);
      }
#pragma unroll
      for (int k = 0; k < 64 / 16; ++k) {
        wgmma<NP, 1, 0>(dw, dfm + 128 * k, ddh + 2 * k, 1);
        wgmma<NP, 1, 0>(dw, dfm + 128 * k, ddl + 2 * k, 1);
      }
      if constexpr (L::SPLIT) {
        const uint64_t dfml = desc_sw128(fa + 8192, L::FT / 2, 1024);
#pragma unroll
        for (int k = 0; k < 64 / 16; ++k) wgmma<NP, 1, 0>(dw, dfml + 128 * k, ddh + 2 * k, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(df);
      fence_acc(dw);
      fence_regs(ah);
      fence_regs(al);
      mbar_arrive(&empty[s]);

      // dfeat: rounded to T, staged as the TMA store's box (bf16: 128-byte
      // rows, swizzled; f32: 256-byte rows), stored by one thread; rows
      // past n are not written.  The box is rewritten a tile later, after
      // the dlog^T barrier, by which time the store has read it.
      uint8_t* so = smem + L::O_OFF + wg * 64 * L::LDO;
      if constexpr (L::SPLIT) {
#pragma unroll
        for (int j = 0; j < CF / 8; ++j) {
          const int k = 8 * j + 2 * q;
          *reinterpret_cast<float2*>(so + lr * L::LDO + 4 * k) = make_float2(df[4 * j], df[4 * j + 1]);
          *reinterpret_cast<float2*>(so + (lr + 8) * L::LDO + 4 * k) =
              make_float2(df[4 * j + 2], df[4 * j + 3]);
        }
      } else {
        // bf16 pairs by stmatrix: matrices (features 16jj + {0-7, 0-7, 8-15,
        // 8-15}) x (pixels {0-7, 8-15, 0-7, 8-15} of this warp's 16); lane
        // 8i + k stores pixel row 16 warp + 8 (i % 2) + k, its chunk 2jj +
        // i / 2 at chunk (2jj + i / 2) ^ k of the swizzled row
        const int i = lane >> 3, k = lane & 7;
        uint8_t* row = so + (warp * 16 + (i & 1) * 8 + k) * 128;
#pragma unroll
        for (int jj = 0; jj < CF / 16; ++jj) {
          uint32_t r[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(df[8 * jj + 2 * h], df[8 * jj + 2 * h + 1]);
            r[h] = *reinterpret_cast<const uint32_t*>(&v);
          }
          stmatrix_x4(row + ((((2 * jj + (i >> 1)) ^ k) & 7) << 4), r[0], r[1], r[2], r[3]);
        }
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if (lt == 0) {
        tma_store_2d(omap, so, 0, static_cast<int>(tile * TILE + wg * 64));
        bulk_commit();
      }
    }
  }
  if constexpr (BWD) {
    if (lt == 0) bulk_wait<0>();  // the last tile's dfeat is written
  }

  // ---- the block's partial row, reduced in a fixed order -----------------
  const int ROWLEN = BWD ? 65 * C : 2 + 5 * C;
  float* row = a.partial + static_cast<size_t>(blockIdx.x) * ROWLEN;
  float* red = reinterpret_cast<float*>(smem);  // the ring, idle now
  bar_sync(3, CONSUMERS);  // every tile consumed: no load in flight
  const int w8 = wg * 4 + warp;
  if constexpr (!BWD) {
#pragma unroll
    for (int i = 0; i < NP / 4; ++i) {
      ps[i] = column_sum(ps[i]);
      tp[i] = column_sum(tp[i]);
      if constexpr (RC) {
        ts[i] = column_sum(ts[i]);
        tpt[i] = column_sum(tpt[i]);
        pts[i] = column_sum(pts[i]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s_wnll += __shfl_xor_sync(0xffffffffu, s_wnll, o);
      s_w += __shfl_xor_sync(0xffffffffu, s_w, o);
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          red[(w8 * 5) * NP + c] = tp[2 * j + e];
          red[(w8 * 5 + 1) * NP + c] = ps[2 * j + e];
          if constexpr (RC) {
            red[(w8 * 5 + 2) * NP + c] = ts[2 * j + e];
            red[(w8 * 5 + 3) * NP + c] = tpt[2 * j + e];
            red[(w8 * 5 + 4) * NP + c] = pts[2 * j + e];
          }
        }
    }
    if (lane == 0) {
      red[40 * NP + 2 * w8] = s_wnll;
      red[40 * NP + 2 * w8 + 1] = s_w;
    }
    bar_sync(3, CONSUMERS);
    if (tid < C) {  // tp, psum, tsum, tp@0.5, pos@0.5: warps in order
      float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      for (int w = 0; w < 8; ++w)
#pragma unroll
        for (int k = 0; k < (RC ? 5 : 2); ++k) v[k] += red[(5 * w + k) * NP + tid];
      if constexpr (!RC) {
        v[2] = static_cast<float>(si[S_TS + tid]);
        v[3] = static_cast<float>(si[S_TPT + tid]);
        v[4] = static_cast<float>(si[S_PTS + tid]);
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) row[2 + k * C + tid] = v[k];
    } else if (tid == 128) {
      float x0 = 0.f, x1 = 0.f;
      for (int w = 0; w < 8; ++w) {
        x0 += red[40 * NP + 2 * w];
        x1 += red[40 * NP + 2 * w + 1];
      }
      row[0] = x0;
      row[1] = x1;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP / 4; ++i) db[i] = column_sum(db[i]);
    // dW accumulators: rows (features) lr, lr + 8, columns (classes) 8j + 2q + e
    float* rdw = red;                // wg 1's dW (64 x NP)
    float* rdb = red + 64 * NP;      // db by warp (8 x NP)
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          rdw[lr * NP + c] = dw[4 * j + e];
          rdw[(lr + 8) * NP + c] = dw[4 * j + 2 + e];
        }
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) rdb[w8 * NP + 8 * j + 2 * q + e] = db[2 * j + e];
    }
    bar_sync(3, CONSUMERS);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          if (c < C) {
            row[c * CF + lr] = dw[4 * j + e] + rdw[lr * NP + c];
            row[c * CF + lr + 8] = dw[4 * j + 2 + e] + rdw[(lr + 8) * NP + c];
          }
        }
    } else if (lt < C) {
      float s_ = 0.f;
      for (int w = 0; w < 8; ++w) s_ += rdb[w * NP + lt];
      row[CF * C + lt] = s_;
    }
  }

  // ---- the last block adds the rows in row order, then the epilogue ------
  if (!last_block(a.ticket, &si[S_LAST], 3, CONSUMERS)) return;
  const int G = gridDim.x;
  if constexpr (!BWD) {
    float* S = red;  // the sums
    for (int j = tid; j < ROWLEN; j += CONSUMERS) {
      const float v = row_order_sum(a.partial, G, ROWLEN, j);
      S[j] = v;
      a.res[1 + 2 * C + j] = v;
    }
    bar_sync(3, CONSUMERS);
    finish(S, C, a.with_dice, 0.f, a.loss, a.fscore, a.res, red + 1024, 3, CONSUMERS);
  } else {
    for (int j = tid; j < ROWLEN; j += CONSUMERS) {
      const float v = row_order_sum(a.partial, G, ROWLEN, j);
      // dW (C, 64) then db (C)
      void* dst = j < CF * C ? a.dw : a.db;
      const int o = j < CF * C ? j : j - CF * C;
      if (a.grad_bf16)
        static_cast<bf16*>(dst)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(dst)[o] = v;
    }
    if (tid < C) {
      a.coefs[tid] = sm[S_A + tid];
      a.coefs[C + tid] = sm[S_B + tid];
    }
    if (tid == 0) a.coefs[2 * C] = inv;
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 1)
final_loss_fwd_kernel(const __grid_constant__ CUtensorMap fmap,
                      const __grid_constant__ CUtensorMap tmap,
                      const __grid_constant__ CUtensorMap omap, const Args a) {
  final_loss_body<T, NP, false>(&fmap, &tmap, &omap, a);
}

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 1)
final_loss_bwd_kernel(const __grid_constant__ CUtensorMap fmap,
                      const __grid_constant__ CUtensorMap tmap,
                      const __grid_constant__ CUtensorMap omap, const Args a) {
  final_loss_body<T, NP, true>(&fmap, &tmap, &omap, a);
}

// A (n, 64) map in T of 128-pixel boxes (the feature tiles; `rows` 64:
// the backward's dfeat boxes): bf16 rows of 128 bytes swizzled, f32 rows
// of 256 bytes plain (split in the kernel).
template <typename T>
cudaError_t feature_map(CUtensorMap* m, const void* base, long long n, int rows) {
  const bool f32 = sizeof(T) == 4;
  const cuuint64_t d[2] = {CF, static_cast<cuuint64_t>(n)};
  const cuuint64_t st[1] = {CF * sizeof(T)};
  const cuuint32_t box[2] = {CF, static_cast<cuuint32_t>(rows)};
  return encode_map(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    2, base, d, st, box,
                    f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}

// the targets (n) uint8 in 128-byte boxes
inline cudaError_t target_map(CUtensorMap* m, const uint8_t* target, long long n) {
  const cuuint64_t d[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t st[1] = {1};
  const cuuint32_t box[1] = {TILE};
  return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, target, d, st, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename T, int NP, bool BWD>
cudaError_t launch_np(const void* feats, const uint8_t* target, const Args& a, int stages,
                      int smem, int grid, cudaStream_t stream) {
  using L = Layout<T, NP, BWD>;
  if (stages != L::STAGES || smem != L::DYN) return cudaErrorInvalidValue;
  CUtensorMap fm, tm, om;
  cudaError_t e = feature_map<T>(&fm, feats, a.n, TILE);
  if (e == cudaSuccess) e = target_map(&tm, target, a.n);
  if (e == cudaSuccess) e = BWD ? feature_map<T>(&om, a.dfeat, a.n, 64) : feature_map<T>(&om, feats, a.n, TILE);
  if (e != cudaSuccess) return e;
  auto kernel = BWD ? final_loss_bwd_kernel<T, NP> : final_loss_fwd_kernel<T, NP>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DYN);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, L::DYN, stream>>>(fm, tm, om, a);
  return cudaGetLastError();
}

// the plan's NP (C rounded up to 16, 32, 64 or 128), grid (the tiles, at
// most CTAS) and shared memory, checked against the kernel's own layout
template <bool BWD>
cudaError_t launch(const void* feats, int is_bf16, const uint8_t* target, const Args& a, int np,
                   int stages, int smem, int grid, cudaStream_t stream) {
  const long long tiles = (a.n + TILE - 1) / TILE;
  const int expect_np = a.C <= 16 ? 16 : a.C <= 32 ? 32 : a.C <= 64 ? 64 : 128;
  if (a.n < 1 || a.C < 1 || a.C > 126 || np != expect_np ||
      grid != (tiles < CTAS ? static_cast<int>(tiles) : CTAS) ||
      (reinterpret_cast<uintptr_t>(feats) & 15) || (reinterpret_cast<uintptr_t>(target) & 15) ||
      (BWD && (reinterpret_cast<uintptr_t>(a.dfeat) & 15)))
    return cudaErrorInvalidValue;
#define TU_LOSS_NP(T, NP)                                                              \
  if (np == NP) return launch_np<T, NP, BWD>(feats, target, a, stages, smem, grid, stream);
  if (is_bf16) {
    TU_LOSS_NP(bf16, 16) TU_LOSS_NP(bf16, 32) TU_LOSS_NP(bf16, 64) TU_LOSS_NP(bf16, 128)
  } else {
    TU_LOSS_NP(float, 16) TU_LOSS_NP(float, 32) TU_LOSS_NP(float, 64) TU_LOSS_NP(float, 128)
  }
#undef TU_LOSS_NP
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// feats (n, 64) bf16 or f32, target (n) uint8, wt (C, 64) and bias (C) in
// the feature dtype, cw (C) f32 class weights; partial (grid, 2 + 5C)
// scratch, ticket (1) zero; out: loss, fscore (scalars) and res (3 + 7C):
// [s_w, denom[C], score[C], sums[2 + 5C]].  np / stages / smem / grid from
// kernels/loss.py::final_loss_plan.
extern "C" int tu_final_ce_dice_fwd(const void* feats, int is_bf16, const uint8_t* target,
                                    const void* wt, const void* bias, const float* cw,
                                    float* partial, unsigned* ticket, float* loss,
                                    float* fscore, float* res, long long n, int C,
                                    int with_dice, int np, int stages, int smem, int grid,
                                    cudaStream_t stream) {
  Args a{};
  a.wt = wt;
  a.bias = bias;
  a.cw = cw;
  a.partial = partial;
  a.ticket = ticket;
  a.n = n;
  a.C = C;
  a.with_dice = with_dice;
  a.loss = loss;
  a.fscore = fscore;
  a.res = res;
  return launch<false>(feats, is_bf16, target, a, np, stages, smem, grid, stream);
}

// + gl (scalar) the loss cotangent and the forward's residuals s_w
// (scalar), denom (C), score (C), all f32; dfeat (n, 64) in the feature
// dtype; dw (C, 64) and db (C) bf16 with grad_bf16, else f32; coefs
// (2C + 1): [A[C], B[C], inv]; partial (grid, 65C) scratch.
extern "C" int tu_final_ce_dice_bwd(const void* feats, int is_bf16, const uint8_t* target,
                                    const void* wt, const void* bias, const float* cw,
                                    const float* gl, const float* s_w, const float* denom,
                                    const float* score, float* partial, unsigned* ticket,
                                    void* dfeat, void* dw, void* db, float* coefs, long long n,
                                    int C, int with_dice, int grad_bf16, int np, int stages,
                                    int smem, int grid, cudaStream_t stream) {
  Args a{};
  a.wt = wt;
  a.bias = bias;
  a.cw = cw;
  a.partial = partial;
  a.ticket = ticket;
  a.n = n;
  a.C = C;
  a.with_dice = with_dice;
  a.gl = gl;
  a.s_w = s_w;
  a.denom = denom;
  a.score = score;
  a.dfeat = dfeat;
  a.dw = dw;
  a.db = db;
  a.coefs = coefs;
  a.grad_bf16 = grad_bf16;
  return launch<true>(feats, is_bf16, target, a, np, stages, smem, grid, stream);
}
