// ce_dice: the training loss on a (pixels, C) logit map — weighted
// cross-entropy (ignore class C, mean by the weight sum) or the focal loss
// (mean over all pixels), + soft dice (beta 1) + the f_score metric at
// threshold 0.5 — and its gradient d loss / d logits.
//
// Replaces tpu_unet/kernels/loss.py::_reductions (the Pallas call at
// loss.py:173) with tu_ce_dice_fwd and ::_vjp_bwd (:313) with
// tu_ce_dice_bwd; the math of _reduce_body / _grad_body (:43-116), and of
// _fwd_impl's loss and f_score (:248-265) and _dice_coefs (:275-294).
//
//   forward:  per pixel p = softmax(x) in f32, t = min(target, C), w =
//             cw[t] for t < C, else 0, nll = log sum e + max - x[t], the
//             sums [S, sum w, tp[C], psum[C], tsum[C], tp@0.5[C],
//             pos@0.5[C]] with S = sum w*nll (CE) or sum alpha*(1 -
//             e^-u)^gamma*u, u = w*nll (focal); an ignored pixel counts in
//             psum and pos@0.5, a pixel past n nowhere, as in _reduce_body;
//             then, on the device, the loss (CE: S / max(sum w, 1e-12);
//             focal: S / n), f_score and the residuals (s_w, denom[C],
//             score[C]) of kernels/loss.py::_finish.
//   backward: from the residuals and the loss cotangent gl, on the device,
//             A[c], B[c] (dice_coefs) and inv = gl / max(s_w, 1e-12) (CE)
//             or gl / n (focal); then
//             dlog = k*w*(p - onehot)*inv + p*((A*onehot + B) - sum_c (A*onehot + B)*p)
//             with k = 1 (CE) or alpha*[(1-pt)^gamma + gamma*u*pt*(1-pt)^(gamma-1)],
//             pt = e^-u, 1 - pt clamped at 1e-12 (focal); written in the
//             logits' dtype.
//
// Design (one template, two kernels, one launch a pass, no eager op
// around it): a persistent grid of at most CTAS blocks, a constant, so
// the pixels behind each block's partial sums depend on n alone; block i
// takes the tiles i, i + grid, ...  A tile is `tile` pixels (plan_for):
// its tile * C contiguous logits and its tile target bytes, which one
// thread of the producer warp streams with 1-D bulk copies into a ring of
// up to 8 stages (mbarriers full / empty).  At C = 4 bf16 a stage is 16 KB
// of logits and 2 KB of targets, 8 stages (144 KB) in flight an SM.  A
// ragged last tile moves its bytes rounded down to 16 that way; its
// threads read (and the backward writes) the rest in device memory.
// Sixteen consumer warps, each thread two pixel slots at once (two
// independent chains of the latency-bound softmax): G threads take a
// pixel (G = 1 for C <= 8, else ceil(C / 8) rounded up to a power of two),
// each holding K (4, 6 or 8) of its classes, c = j + G*k, read straight
// from the staged bytes (one 8- or 16-byte word a pixel at C = 4); the max
// and the sum by shuffles within the group; one exponential a logit, e =
// 2^((x - max) log2 e), p = e * rcp(sum e), nll = log(sum e) + max - x[t]
// (the hardware's lg2, ln 2 * lg2(sum), exact at sum = 1); x[t] read again
// from the stage by its index.  A full tile's slots check nothing against
// n; the ragged tile's take a second instantiation of the same code.
//   forward  each thread sums, over the classes it holds, psum (float)
//            and pos@0.5 (integer) in registers; where it holds the target
//            class, p[t] (recomputed by the same operations), S and sum w,
//            and tp (float), tsum and tp@0.5 (integers) in its own shared
//            memory slot of that class (an index into registers would be
//            local memory); the counts are exact.  At the end the block
//            reduces them in a fixed order (shuffles over the lanes of the
//            same classes, then the warps in order) into its partial row;
//            the last block, found by an integer ticket, adds the rows in
//            row order and runs _finish (loss_common.cuh, shared with #27 /
//            #29).  No float atomics: the loss is the same on every run.
//   backward each block computes A, B and inv in its prologue from device
//            pointers; dlog overwrites the staged logits in the logits' dtype
//            and one bulk store a tile writes them back; a stage is refilled
//            once its store has read it.
//
// Bound on the H100 (bytes: logits and one-byte targets read once, dlogits
// written once, at 3.35 TB/s):
//   32 x 256^2 x 4 bf16 (the DataB presets): forward 18.87 MB, 5.6 us;
//     backward 35.65 MB, 10.6 us;
//   8 x 512^2 x 21 bf16: forward 90.18 MB, 26.9 us; backward 178.3 MB,
//     53.2 us.
// Both passes are bound by instructions, not bytes: at C = 4 a pixel takes
// ~117 instructions in the forward (the softmax, the per-class sums, the
// target's sums, the focal term), ~8 us of issue at the full rate against
// 5.6 us of bytes, and the forward's epilogue (block reduction, ticket,
// the last block's sums) adds ~5 us; at C = 21 a pixel's 24 class slots
// (4 threads of 6) take ~13 instructions each.  On an H100 (700 W): 0.021
// / 0.019 ms at the first shape, 0.082 / 0.110 at the second.
// Limits: 1 <= C <= 126 (the TPU kernel's int8 target encoding), logits
// bf16 or f32.
#include <type_traits>

#include "loss_common.cuh"

namespace {

using namespace tu::sm90;
using namespace tu::loss;
using bf16 = __nv_bfloat16;

constexpr int NC = 512;             // consumer threads: sixteen warps
constexpr int THREADS = NC + 32;    // and one producer warp
constexpr int R = 2;                // pixel slots a consumer thread takes at once
constexpr int CTAS = 132;           // the most blocks of a pass (partial rows)
constexpr int SMEM_MAX = 232448;    // a block's dynamic shared memory, 227 KB
constexpr int MAX_STAGES = 8;
constexpr int STAGE_BYTES = 16384;  // the logit bytes a stage aims at
constexpr int MAX_TILE = 2048;
constexpr int SMALL = 4096;         // per-class constants, scalars
constexpr int NO_CLASS = 1024;      // the target of an ignored pixel or a row past n
constexpr int TARGET_SUMS = 12;     // bytes a class slot of a consumer thread (forward)
// SMALL, in floats: cw[128], B[128], A + B[128], inv, the last-block flag
constexpr int S_CW = 0, S_B = 128, S_AB = 256, S_INV = 384, S_LAST = 385;
constexpr unsigned FULL = 0xffffffffu;
// the logit of a class past C: its exponential is 0, and times 0 it is 0
// (the target's logit is picked by a product, not an index)
constexpr float PAD = -1e30f;

// G threads a pixel (1 for C <= 8, else ceil(C / 8) rounded up to a power
// of two) and K classes a thread (4, 6 or 8, the fewest that hold C)
inline int threads_a_pixel(int C) {
  int g = 1;
  while (8 * g < C) g <<= 1;
  return g;
}
inline int classes_a_thread(int C) {
  const int g = threads_a_pixel(C);
  return C <= 4 ? 4 : (C + g - 1) / g <= 6 ? 6 : 8;
}

// The launch plan (kernels/loss.py::logit_loss_plan mirrors it): the
// tile's pixels (a power of two, so its logits and targets are whole
// multiples of 16 bytes: the largest up to MAX_TILE whose logits fit
// STAGE_BYTES, but R * NC pixel slots at least, so that every step of
// every consumer thread is whole), the stages (as many as fit, up to
// MAX_STAGES), the dynamic shared memory (the ring's logits and targets,
// the forward's target sums, SMALL, the barriers).
struct Plan {
  int tile, stages, smem;
};

inline Plan plan_for(int C, int size, bool bwd) {
  const int b = C * size, g = threads_a_pixel(C);
  int tile = MAX_TILE;
  while (tile * b > STAGE_BYTES && tile * g > R * NC) tile >>= 1;
  const int per_stage = tile * b + tile + 16;
  const int fixed = SMALL + (bwd ? 0 : TARGET_SUMS * classes_a_thread(C) * NC);
  const int fit = (SMEM_MAX - fixed) / per_stage;
  const int stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  return {tile, stages, fixed + stages * per_stage};
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// b^g: b * b at the presets' g = 2 and b at g = 1, as torch's pow gives them
__device__ __forceinline__ float fpow(float b, float g) {
  return g == 2.f ? b * b : g == 1.f ? b : powf(b, g);
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The K logits c = j + G*k of the pixel whose row starts at element e0 of
// the tile, as float (PAD past C), from the stage L; in a ragged last tile
// (RG), from device memory g at and past element `lim`.  One vector load
// where a thread holds the whole row.  A full tile's code names only the
// stage, so that its loads are shared-memory loads.
template <typename T, int K, int G, bool RG>
__device__ __forceinline__ void load_row(float (&x)[K], const T* L, const T* g, int e0, int j,
                                         int C, int lim) {
  constexpr int BYTES = K * static_cast<int>(sizeof(T)), V = 16 / static_cast<int>(sizeof(T));
  constexpr bool VEC = G == 1 && (BYTES == 8 || BYTES % 16 == 0);
  if (VEC && C == K && (!RG || e0 + K <= lim)) {
    if constexpr (!VEC) {
    } else if constexpr (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(L + e0);
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < K; ++k) x[k] = to_f(v[k]);
    } else {
#pragma unroll
      for (int h = 0; h < BYTES / 16; ++h) {
        const uint4 u = reinterpret_cast<const uint4*>(L + e0)[h];
        const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int k = 0; k < V; ++k) x[h * V + k] = to_f(v[k]);
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = j + G * k, e = e0 + c;
    if constexpr (RG)
      x[k] = c < C ? to_f(e < lim ? L[e] : g[e]) : PAD;
    else
      x[k] = c < C ? to_f(L[e]) : PAD;
  }
}

// d (the classes c = j + G*k < C) into the stage L (in a ragged last tile,
// into device memory g at and past element `lim`), rounded to T
template <typename T, int K, int G, bool RG>
__device__ __forceinline__ void store_row(const float (&d)[K], T* L, T* g, int e0, int j, int C,
                                          int lim) {
  constexpr int BYTES = K * static_cast<int>(sizeof(T));
  constexpr bool VEC = G == 1 && (BYTES == 8 || BYTES % 16 == 0);
  if (VEC && C == K && (!RG || e0 + K <= lim)) {
    __align__(16) T v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = from_f<T>(d[k]);
    if constexpr (!VEC) {
    } else if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(L + e0) = *reinterpret_cast<const uint2*>(v);
    } else {
#pragma unroll
      for (int h = 0; h < BYTES / 16; ++h)
        reinterpret_cast<uint4*>(L + e0)[h] = reinterpret_cast<const uint4*>(v)[h];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = j + G * k, e = e0 + c;
    if (c < C) {
      if (!RG || e < lim)
        L[e] = from_f<T>(d[k]);
      else
        g[e] = from_f<T>(d[k]);
    }
  }
}

struct Args {
  const void* logits;      // (n, C), T
  const uint8_t* target;   // (n)
  const float* cw;         // (C) class weights
  long long n;
  int C, with_dice, focal;
  float alpha, gamma;
  int tile, stages;
  // forward: partial (grid, 2 + 5C) scratch; the ticket; loss, f_score
  // and res = [s_w, denom[C], score[C], sums[2 + 5C]]
  float* partial;
  unsigned* ticket;
  float* loss;
  float* fscore;
  float* res;
  // backward: gl, and the forward's s_w, denom, score; dlogits (n, C) in T;
  // coefs = [A[C], B[C], inv] as block 0 computed them
  const float* gl;
  const float* s_w;
  const float* denom;
  const float* score;
  void* dlogits;
  float* coefs;
};

// The body of both passes (a kernel each, so a profile names them apart).
template <typename T, int K, int G, bool BWD>
__device__ __forceinline__ void logit_loss_body(const Args& a) {
  // used as it is (16-byte aligned, as bulk copies want it): a pointer
  // rounded through an integer would be a generic one, and every access
  // through it a generic load or store
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = a.C, P = a.tile, S = a.stages, tid = threadIdx.x;
  constexpr int TS = static_cast<int>(sizeof(T));
  const int LB = P * C * TS;    // a stage's logit bytes
  uint8_t* tg = smem + S * LB;  // the stages' target bytes
  // forward: each consumer thread's sums at the target class, [K][NC]:
  // tp (float), tsum and tp@0.5 (int); then SMALL
  [[maybe_unused]] float* tpS = reinterpret_cast<float*>(tg + S * P);
  [[maybe_unused]] int* tsS = reinterpret_cast<int*>(tpS + K * NC);
  [[maybe_unused]] int* tptS = tsS + K * NC;
  float* sm = reinterpret_cast<float*>(tg + S * P + (BWD ? 0 : TARGET_SUMS * K * NC));
  int* si = reinterpret_cast<int*>(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(sm) + SMALL);
  uint64_t* empty = full + S;
  const long long n = a.n, ntiles = (n + P - 1) / P;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], BWD ? 1 : NC);  // the backward's storing thread, or every consumer
    }
    mbar_init_fence();
  }
  if (tid < 128) {
    const bool real = tid < C;
    sm[S_CW + tid] = real ? a.cw[tid] : 0.f;
    if constexpr (BWD) {
      // dice_coefs and _inv (kernels/loss.py), the same float32 operations
      const float g = *a.gl;
      float ca = 0.f, cb = 0.f;
      if (real && a.with_dice) dice_coef(g, a.denom[tid], a.score[tid], C, ca, cb);
      sm[S_B + tid] = cb;
      sm[S_AB + tid] = ca + cb;
      const float inv = a.focal ? g / static_cast<float>(n) : g / fmaxf(*a.s_w, 1e-12f);
      if (tid == 0) sm[S_INV] = inv;
      if (blockIdx.x == 0) {
        if (real) {
          a.coefs[tid] = ca;
          a.coefs[C + tid] = cb;
        }
        if (tid == 0) a.coefs[2 * C] = inv;
      }
    }
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp: one thread issues every copy
    if (tid == NC) {
      const uint8_t* src = static_cast<const uint8_t*>(a.logits);
      int it = 0;
      for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
        const long long p0 = tile * P;
        const int rows = static_cast<int>(n - p0 < P ? n - p0 : P);
        const uint32_t lb = static_cast<uint32_t>(rows * C * TS) & ~15u;
        const uint32_t tb = static_cast<uint32_t>(rows) & ~15u;
        mbar_expect_tx(&full[s], lb + tb);
        if (lb) bulk_load(smem + s * LB, src + p0 * C * TS, lb, &full[s]);
        if (tb) bulk_load(tg + s * P, a.target + p0, tb, &full[s]);
      }
    }
    return;
  }

  const int j = tid & (G - 1), warp = tid >> 5, lane = tid & 31;
  const bool focal = a.focal;
  const float alpha = a.alpha, gamma = a.gamma;
  // forward: this thread's sums over its classes j + G*k (those at the
  // target class in tpS / tsS / tptS)
  [[maybe_unused]] float ps[K], s0 = 0.f, s1 = 0.f;
  [[maybe_unused]] int pos[K];
  // backward: B and A + B of its classes, and inv
  [[maybe_unused]] float bk[K], abk[K];
  [[maybe_unused]] const float inv = BWD ? sm[S_INV] : 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (BWD) {
      bk[k] = sm[S_B + j + G * k];
      abk[k] = sm[S_AB + j + G * k];
    } else {
      ps[k] = 0.f;
      pos[k] = 0;
      tpS[k * NC + tid] = 0.f;
      tsS[k * NC + tid] = tptS[k * NC + tid] = 0;
    }
  }

  int it = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    const long long p0 = tile * P;
    const int rows = static_cast<int>(n - p0 < P ? n - p0 : P);
    // the elements and target bytes the copies staged (all, but in a
    // ragged last tile)
    const int lim = (rows * C * TS & ~15) / TS, tlim = rows & ~15;
    T* L = reinterpret_cast<T*>(smem + s * LB);
    const uint8_t* Tg = tg + s * P;
    const T* gsrc = static_cast<const T*>(a.logits) + p0 * C;
    [[maybe_unused]] T* gdst = BWD ? static_cast<T*>(a.dlogits) + p0 * C : nullptr;
    // R slots a thread a step, q0 and q0 + NC: P * G is a multiple of
    // R * NC, so every step is whole (and every warp's shuffles).  A full
    // tile (RG false) checks no row against n and reads only the stage.
    auto slots = [&](auto ragged) {
      constexpr bool RG = decltype(ragged)::value;
      const int lm = RG ? lim : P * C;
      for (int q0 = tid; q0 < P * G; q0 += R * NC) {
        float x[R][K], m[R], sum[R], r[R];
        int t[R], e0[R];
        bool valid[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int i = (q0 + u * NC) / G;
          valid[u] = !RG || i < rows;
          const int iv = valid[u] ? i : 0;  // a row past n reads row 0 and counts nowhere
          e0[u] = iv * C;
          int raw;
          if constexpr (RG)
            raw = iv < tlim ? Tg[iv] : a.target[p0 + iv];
          else
            raw = Tg[iv];
          t[u] = valid[u] && raw < C ? raw : NO_CLASS;  // the ignore class matches no class
          load_row<T, K, G, RG>(x[u], L, gsrc, e0[u], j, C, lm);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          m[u] = x[u][0];
#pragma unroll
          for (int k = 1; k < K; ++k) m[u] = fmaxf(m[u], x[u][k]);
          m[u] = group_max<G>(m[u]);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          sum[u] = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            x[u][k] = ex2((x[u][k] - m[u]) * LOG2E);  // 1 at the max, 0 past C
            sum[u] += x[u][k];
          }
          sum[u] = group_sum<G>(sum[u]);
          r[u] = valid[u] ? rcp(sum[u]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          // the CE weight and the target's logit, read again by its index
          const bool real = t[u] != NO_CLASS;
          const int et = e0[u] + (real ? t[u] : 0);
          const float w = real ? sm[S_CW + t[u]] : 0.f;
          float xt = 0.f;
          if constexpr (RG)
            xt = real ? to_f(et < lm ? L[et] : gsrc[et]) : 0.f;
          else
            xt = real ? to_f(L[et]) : 0.f;
          if constexpr (!BWD) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float p = x[u][k] * r[u];
              ps[k] += p;
              pos[k] += p > 0.5f;
            }
            if (real && (t[u] & (G - 1)) == j) {  // the lane that holds class t
              // p[t] (the same operations as the class's slot), and S, sum w
              const float pt = ex2((xt - m[u]) * LOG2E) * r[u];
              const int at = (t[u] / G) * NC + tid;
              tpS[at] += pt;
              tsS[at] += 1;
              tptS[at] += pt > 0.5f;
              const float wnll = w * (__logf(sum[u]) + m[u] - xt);
              s0 += focal ? alpha * fpow(1.f - ex2(-wnll * LOG2E), gamma) * wnll : wnll;
              s1 += w;
            }
          } else {
            float inner = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              x[u][k] *= r[u];
              inner += (j + G * k == t[u] ? abk[k] : bk[k]) * x[u][k];
            }
            inner = group_sum<G>(inner);
            float kw = w;  // the CE factor k * w
            if (focal) {
              const float wnll = w * (__logf(sum[u]) + m[u] - xt);
              const float pt = ex2(-wnll * LOG2E);
              const float base = fmaxf(1.f - pt, 1e-12f);
              kw = alpha * (fpow(base, gamma) + gamma * wnll * pt * fpow(base, gamma - 1.f)) * w;
            }
            const float kwi = kw * inv;
            float d[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const bool hit = j + G * k == t[u];
              d[k] = (hit ? x[u][k] - 1.f : x[u][k]) * kwi +
                     x[u][k] * ((hit ? abk[k] : bk[k]) - inner);
            }
            if (valid[u]) store_row<T, K, G, RG>(d, L, gdst, e0[u], j, C, lm);
          }
        }
      }
    };
    if (rows == P)
      slots(std::false_type{});
    else
      slots(std::true_type{});
    if constexpr (!BWD) {
      mbar_arrive(&empty[s]);  // done with the stage
    } else {
      // the tile's dlogits are in the stage: one bulk store; the stage of
      // the tile before is free once its store has read it
      fence_proxy_async();
      bar_sync(1, NC);
      if (tid == 0) {
        const uint32_t lb = static_cast<uint32_t>(lim * TS);
        if (lb) bulk_store(gdst, L, lb);
        bulk_commit();
        bulk_wait_read<1>();
        if (it > 0) mbar_arrive(&empty[(it - 1) % S]);
      }
    }
  }

  if constexpr (BWD) {
    if (tid == 0) bulk_wait<0>();  // the last tile's dlogits are written
  } else {
    // ---- the block's partial row, reduced in a fixed order --------------
    const int M = 2 + 5 * C;
    float* row = a.partial + static_cast<size_t>(blockIdx.x) * M;
    float* red = reinterpret_cast<float*>(smem);  // the ring, idle now
    int* ired = reinterpret_cast<int*>(smem);
    bar_sync(1, NC);  // every tile consumed: no copy in flight
    float tp[K];
    int ts[K], tpt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tp[k] = tpS[k * NC + tid];
      ts[k] = tsS[k * NC + tid];
      tpt[k] = tptS[k * NC + tid];
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {  // the lanes of the same classes
        tp[k] += __shfl_xor_sync(FULL, tp[k], o);
        ps[k] += __shfl_xor_sync(FULL, ps[k], o);
        ts[k] += __shfl_xor_sync(FULL, ts[k], o);
        tpt[k] += __shfl_xor_sync(FULL, tpt[k], o);
        pos[k] += __shfl_xor_sync(FULL, pos[k], o);
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(FULL, s0, o);
      s1 += __shfl_xor_sync(FULL, s1, o);
    }
    // red[(warp * 5 + q) * KG + c]: q = tp, psum, tsum, tp@0.5, pos@0.5;
    // then the warps' S and sum w
    constexpr int KG = K * G, WARPS = NC / 32;
    if (lane < G) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = lane + G * k;
        red[(warp * 5) * KG + c] = tp[k];
        red[(warp * 5 + 1) * KG + c] = ps[k];
        ired[(warp * 5 + 2) * KG + c] = ts[k];
        ired[(warp * 5 + 3) * KG + c] = tpt[k];
        ired[(warp * 5 + 4) * KG + c] = pos[k];
      }
    }
    if (lane == 0) {
      red[WARPS * 5 * KG + 2 * warp] = s0;
      red[WARPS * 5 * KG + 2 * warp + 1] = s1;
    }
    bar_sync(1, NC);
    if (tid < C) {  // the warps in order; the counts as integers
      float f[2] = {0.f, 0.f};
      int cnt[3] = {0, 0, 0};
      for (int w = 0; w < WARPS; ++w) {
#pragma unroll
        for (int q = 0; q < 2; ++q) f[q] += red[(w * 5 + q) * KG + tid];
#pragma unroll
        for (int q = 0; q < 3; ++q) cnt[q] += ired[(w * 5 + 2 + q) * KG + tid];
      }
      row[2 + tid] = f[0];
      row[2 + C + tid] = f[1];
#pragma unroll
      for (int q = 0; q < 3; ++q) row[2 + (2 + q) * C + tid] = static_cast<float>(cnt[q]);
    } else if (tid == 128) {
      float x0 = 0.f, x1 = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        x0 += red[WARPS * 5 * KG + 2 * w];
        x1 += red[WARPS * 5 * KG + 2 * w + 1];
      }
      row[0] = x0;
      row[1] = x1;
    }

    // ---- the last block adds the rows in row order, then _finish ---------
    if (!last_block(a.ticket, &si[S_LAST], 1, NC)) return;
    float* sums = red;
    for (int jj = tid; jj < M; jj += NC) {
      const float v = row_order_sum(a.partial, gridDim.x, M, jj);
      sums[jj] = v;
      a.res[1 + 2 * C + jj] = v;
    }
    bar_sync(1, NC);
    finish(sums, C, a.with_dice, focal ? static_cast<float>(n) : 0.f, a.loss, a.fscore, a.res,
           red + 1024, 1, NC);
  }
}

template <typename T, int K, int G>
__global__ void __launch_bounds__(THREADS, 1) ce_dice_fwd_kernel(const Args a) {
  logit_loss_body<T, K, G, false>(a);
}

template <typename T, int K, int G>
__global__ void __launch_bounds__(THREADS, 1) ce_dice_bwd_kernel(const Args a) {
  logit_loss_body<T, K, G, true>(a);
}

template <typename T, int K, int G, bool BWD>
cudaError_t launch_kg(const Args& a, int smem, int grid, cudaStream_t stream) {
  auto kernel = BWD ? ce_dice_bwd_kernel<T, K, G> : ce_dice_fwd_kernel<T, K, G>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the plan's tile, stages and shared memory and the grid (the tiles, at
// most CTAS), checked against the kernel's own; K and G from C
template <bool BWD>
cudaError_t launch(int is_bf16, const Args& a, int smem, int grid, cudaStream_t stream) {
  const int C = a.C;
  if (a.n < 1 || C < 1 || C > 126) return cudaErrorInvalidValue;
  const Plan p = plan_for(C, is_bf16 ? 2 : 4, BWD);
  const long long tiles = (a.n + p.tile - 1) / p.tile;
  if (a.tile != p.tile || a.stages != p.stages || smem != p.smem ||
      grid != (tiles < CTAS ? static_cast<int>(tiles) : CTAS) ||
      (reinterpret_cast<uintptr_t>(a.logits) & 15) || (reinterpret_cast<uintptr_t>(a.target) & 15) ||
      (BWD && (reinterpret_cast<uintptr_t>(a.dlogits) & 15)))
    return cudaErrorInvalidValue;
#define TU_LOGIT_KG(K, G)                                                            \
  return is_bf16 ? launch_kg<bf16, K, G, BWD>(a, smem, grid, stream)                 \
                 : launch_kg<float, K, G, BWD>(a, smem, grid, stream);
  const int g = threads_a_pixel(C), k = classes_a_thread(C);
  if (k == 4) TU_LOGIT_KG(4, 1)
  if (g == 1) {
    if (k == 6) TU_LOGIT_KG(6, 1)
    TU_LOGIT_KG(8, 1)
  }
  if (g == 2) {
    if (k == 6) TU_LOGIT_KG(6, 2)
    TU_LOGIT_KG(8, 2)
  }
  if (g == 4) {
    if (k == 6) TU_LOGIT_KG(6, 4)
    TU_LOGIT_KG(8, 4)
  }
  if (g == 8) {
    if (k == 6) TU_LOGIT_KG(6, 8)
    TU_LOGIT_KG(8, 8)
  }
  if (k == 6) TU_LOGIT_KG(6, 16)
  TU_LOGIT_KG(8, 16)
#undef TU_LOGIT_KG
}

}  // namespace

// logits (n, C) bf16 or f32, target (n) uint8, cw (C) f32 class weights;
// partial (grid, 2 + 5C) scratch, ticket (1) zero; out: loss, fscore
// (scalars) and res (3 + 7C): [s_w, denom[C], score[C], sums[2 + 5C]];
// focal 0 or 1 with its alpha and gamma; tile / stages / smem / grid from
// kernels/loss.py::logit_loss_plan and ::logit_loss_grid.
extern "C" int tu_ce_dice_fwd(const void* logits, int is_bf16, const uint8_t* target,
                              const float* cw, float* partial, unsigned* ticket, float* loss,
                              float* fscore, float* res, long long n, int C, int with_dice,
                              int focal, float alpha, float gamma, int tile, int stages, int smem,
                              int grid, cudaStream_t stream) {
  Args a{};
  a.logits = logits;
  a.target = target;
  a.cw = cw;
  a.n = n;
  a.C = C;
  a.with_dice = with_dice;
  a.focal = focal;
  a.alpha = alpha;
  a.gamma = gamma;
  a.tile = tile;
  a.stages = stages;
  a.partial = partial;
  a.ticket = ticket;
  a.loss = loss;
  a.fscore = fscore;
  a.res = res;
  return launch<false>(is_bf16, a, smem, grid, stream);
}

// + gl (scalar) the loss cotangent and the forward's residuals s_w
// (scalar), denom (C), score (C), all f32; dlogits (n, C) in the logits'
// dtype; coefs (2C + 1): [A[C], B[C], inv].
extern "C" int tu_ce_dice_bwd(const void* logits, int is_bf16, const uint8_t* target,
                              const float* cw, const float* gl, const float* s_w,
                              const float* denom, const float* score, void* dlogits, float* coefs,
                              long long n, int C, int with_dice, int focal, float alpha,
                              float gamma, int tile, int stages, int smem, int grid,
                              cudaStream_t stream) {
  Args a{};
  a.logits = logits;
  a.target = target;
  a.cw = cw;
  a.n = n;
  a.C = C;
  a.with_dice = with_dice;
  a.focal = focal;
  a.alpha = alpha;
  a.gamma = gamma;
  a.tile = tile;
  a.stages = stages;
  a.gl = gl;
  a.s_w = s_w;
  a.denom = denom;
  a.score = score;
  a.dlogits = dlogits;
  a.coefs = coefs;
  return launch<true>(is_bf16, a, smem, grid, stream);
}
