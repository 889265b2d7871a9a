// ce_dice: the training loss on a (pixels, C) logit map — weighted
// cross-entropy (ignore class C, mean by the weight sum) or the focal loss
// (mean over all pixels), + soft dice (beta 1) + the f_score metric at
// threshold 0.5 — and its gradient d loss / d logits.
//
// Replaces tpu_unet/kernels/loss.py::_reductions (the Pallas call at
// loss.py:173) with tu_ce_dice_fwd and ::_vjp_bwd (:313) with
// tu_ce_dice_bwd; the math of _reduce_body / _grad_body (:43-116).
//
//   forward:  per pixel p = exp(log_softmax(x)) in f32, t = min(target, C),
//             w = cw[t] for t < C, else 0, nll = -log p[t], and the sums
//             [S, sum w, tp[C], psum[C], tsum[C], tp@0.5[C], pos@0.5[C]]
//             with S = sum w*nll (CE) or sum alpha*(1 - e^-u)^gamma*u,
//             u = w*nll (focal); an ignored pixel counts in psum and
//             pos@0.5, as in _reduce_body.
//   backward: dlog = k*w*(p - onehot)*inv + p*((A*onehot + B) - sum_c (A*onehot + B)*p)
//             with k = 1 (CE) or alpha*[(1-pt)^gamma + gamma*u*pt*(1-pt)^(gamma-1)],
//             pt = e^-u, 1 - pt clamped at 1e-12 (focal); inv = dL / sum w
//             (CE) or dL / pixels (focal); written in the logits' dtype.
//
// Design: 128 pixels a tile.  A tile's 128*C logits are contiguous; the
// block reads them with 16-byte loads into shared memory, transposed to
// [C][129] floats, so that one thread then owns one pixel's row (its
// softmax and its C-long sums stay inside the thread) and the per-class
// sums run across the tile without bank conflicts.  The forward walks the
// tiles grid-stride with at most MAX_BLOCKS blocks, each writing its
// partial sums to a scratch row, and a second launch adds the rows in
// block order (loss_common.cuh): no float atomics, the loss is the same on
// every run.  The backward has no cross-pixel sum: one block a tile, the
// tile's dlogits written back through shared memory with 16-byte stores.
//
// Bound on the H100 (bytes: logits and one-byte targets read once, dlogits
// written once, at 3.35 TB/s):
//   32 x 256^2 x 4 bf16 (the DataB presets): forward 18.87 MB, 5.6 us;
//     backward 35.65 MB, 10.6 us -- both launch-bound at this size;
//   8 x 512^2 x 21 bf16: forward 90.18 MB, 26.9 us; backward 178.3 MB,
//     53.2 us.
// Limits: 1 <= C <= 126 (the TPU kernel's int8 target encoding), logits
// bf16 or f32.
#include "loss_common.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// The `count` logits of a tile (whole rows of C from `src`) into
// L[c * LDP + row]: 16 bytes a thread where the tile is 16-byte aligned,
// then one value a thread for the rest.
template <typename T>
__device__ void load_tile(const T* __restrict__ src, int count, float* L, int C) {
  constexpr int V = 16 / sizeof(T);
  const int nv = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? count / V : 0;
  for (int i = threadIdx.x; i < nv; i += NT) {
    const uint4 u = reinterpret_cast<const uint4*>(src)[i];
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int e = i * V + j, r = e / C;
      L[(e - r * C) * LDP + r] = to_f(v[j]);
    }
  }
  for (int e = nv * V + threadIdx.x; e < count; e += NT) {
    const int r = e / C;
    L[(e - r * C) * LDP + r] = to_f(src[e]);
  }
}

// L[c * LDP + row] back into `count` values of dst, rounded to T
template <typename T>
__device__ void store_tile(T* __restrict__ dst, int count, const float* L, int C) {
  constexpr int V = 16 / sizeof(T);
  const int nv = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 ? count / V : 0;
  for (int i = threadIdx.x; i < nv; i += NT) {
    __align__(16) T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int e = i * V + j, r = e / C;
      v[j] = from_f<T>(L[(e - r * C) * LDP + r]);
    }
    reinterpret_cast<uint4*>(dst)[i] = *reinterpret_cast<const uint4*>(v);
  }
  for (int e = nv * V + threadIdx.x; e < count; e += NT) {
    const int r = e / C;
    dst[e] = from_f<T>(L[(e - r * C) * LDP + r]);
  }
}

// Pixel `i` of the tile: its logits L[c * LDP + i] → probabilities
// exp(log_softmax) in place; returns -log p[t] (0 unless t < C).
__device__ __forceinline__ float softmax_col(float* L, int i, int C, int t) {
  float m = -INFINITY;
  for (int c = 0; c < C; ++c) m = fmaxf(m, L[c * LDP + i]);
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += expf(L[c * LDP + i] - m);
  const float ls = logf(s);
  float nll = 0.f;
  for (int c = 0; c < C; ++c) {
    const float lp = L[c * LDP + i] - m - ls;
    if (c == t) nll = -lp;
    L[c * LDP + i] = expf(lp);
  }
  return nll;
}

template <typename T>
__global__ void __launch_bounds__(NT)
ce_dice_fwd_kernel(const T* __restrict__ logits, const uint8_t* __restrict__ target,
                   const float* __restrict__ cw, float* __restrict__ partial, long long n, int C,
                   int focal, float alpha, float gamma) {
  extern __shared__ float smem[];
  float* L = smem;                                  // C * LDP logits, then probabilities
  int* Ts = reinterpret_cast<int*>(L + C * LDP);    // NT targets
  float* R = reinterpret_cast<float*>(Ts + NT);     // 5 * NT scratch
  const int tid = threadIdx.x;
  ClassSums acc;
  float s0 = 0.f, s1 = 0.f;
  for (long long tile = blockIdx.x; tile * NT < n; tile += gridDim.x) {
    const long long p0 = tile * NT;
    const int rows = static_cast<int>(n - p0 < NT ? n - p0 : NT);
    load_tile<T>(logits + p0 * C, rows * C, L, C);
    __syncthreads();
    int t = C + 1;  // no pixel: matches no class, counts nowhere
    if (tid < rows) {
      t = clamp_target(target[p0 + tid], C);
      const float nll = softmax_col(L, tid, C, t);
      const float w = t < C ? cw[t] : 0.f;
      const float u = w * nll;
      s0 += focal ? alpha * powf(1.f - expf(-u), gamma) * u : u;
      s1 += w;
    } else {
      for (int c = 0; c < C; ++c) L[c * LDP + tid] = 0.f;
    }
    Ts[tid] = t;
    __syncthreads();
    acc.add(L, Ts, C);
    __syncthreads();
  }
  write_partial(partial + static_cast<size_t>(blockIdx.x) * (2 + 5 * C), s0, s1, acc, R, C);
}

template <typename T>
__global__ void __launch_bounds__(NT)
ce_dice_bwd_kernel(const T* __restrict__ logits, const uint8_t* __restrict__ target,
                   const float* __restrict__ cw, const float* __restrict__ coefA,
                   const float* __restrict__ coefB, const float* __restrict__ inv_sw,
                   T* __restrict__ dlogits, long long n, int C, int focal, float alpha,
                   float gamma) {
  extern __shared__ float smem[];
  float* L = smem;  // C * LDP logits, then dlogits
  const int tid = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * NT;
  const int rows = static_cast<int>(n - p0 < NT ? n - p0 : NT);
  load_tile<T>(logits + p0 * C, rows * C, L, C);
  __syncthreads();
  if (tid < rows) {
    const int t = clamp_target(target[p0 + tid], C);
    const float nll = softmax_col(L, tid, C, t);
    const float w = t < C ? cw[t] : 0.f;
    float kw = w;  // the CE factor k * w
    if (focal) {
      const float u = w * nll, pt = expf(-u);
      const float base = fmaxf(1.f - pt, 1e-12f);
      kw = alpha * (powf(base, gamma) + gamma * u * pt * powf(base, gamma - 1.f)) * w;
    }
    const float inv = *inv_sw;
    float inner = 0.f;
    for (int c = 0; c < C; ++c) inner += ((c == t ? coefA[c] : 0.f) + coefB[c]) * L[c * LDP + tid];
    for (int c = 0; c < C; ++c) {
      const float pv = L[c * LDP + tid];
      const float dldp = (c == t ? coefA[c] : 0.f) + coefB[c];
      L[c * LDP + tid] = kw * (pv - (c == t ? 1.f : 0.f)) * inv + pv * (dldp - inner);
    }
  }
  __syncthreads();
  store_tile<T>(dlogits + p0 * C, rows * C, L, C);
}

template <typename T>
cudaError_t fwd(const void* logits, const uint8_t* target, const float* cw, float* partial,
                float* sums, long long n, int C, int focal, float alpha, float gamma,
                cudaStream_t stream) {
  const int nb = blocks_for(n);
  const int M = 2 + 5 * C;
  const size_t smem = sizeof(float) * C * LDP + sizeof(int) * NT + sizeof(float) * 5 * NT;
  cudaError_t e = allow_smem(ce_dice_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  ce_dice_fwd_kernel<T><<<nb, NT, smem, stream>>>(static_cast<const T*>(logits), target, cw,
                                                  partial, n, C, focal, alpha, gamma);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_rows_kernel<<<(M + 127) / 128, 128, 0, stream>>>(partial, sums, nb, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* logits, const uint8_t* target, const float* cw, const float* coefA,
                const float* coefB, const float* inv_sw, void* dlogits, long long n, int C,
                int focal, float alpha, float gamma, cudaStream_t stream) {
  const long long nb = (n + NT - 1) / NT;
  const size_t smem = sizeof(float) * C * LDP;
  cudaError_t e = allow_smem(ce_dice_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  ce_dice_bwd_kernel<T><<<static_cast<unsigned>(nb), NT, smem, stream>>>(
      static_cast<const T*>(logits), target, cw, coefA, coefB, inv_sw, static_cast<T*>(dlogits),
      n, C, focal, alpha, gamma);
  return cudaGetLastError();
}

}  // namespace

// logits (n, C) bf16 or f32, target (n) uint8, cw (C) f32 class weights;
// partial (MAX_BLOCKS, 2 + 5C) scratch; sums (2 + 5C); focal 0 or 1 with
// its alpha and gamma.
extern "C" int tu_ce_dice_fwd(const void* logits, int is_bf16, const uint8_t* target,
                              const float* cw, float* partial, float* sums, long long n, int C,
                              int focal, float alpha, float gamma, cudaStream_t stream) {
  return is_bf16 ? fwd<bf16>(logits, target, cw, partial, sums, n, C, focal, alpha, gamma, stream)
                 : fwd<float>(logits, target, cw, partial, sums, n, C, focal, alpha, gamma, stream);
}

// + coefA, coefB (C) f32 dice coefficients, inv_sw (1) f32 = dL / sum w
// (CE) or dL / n (focal); dlogits (n, C) in the logits' dtype.
extern "C" int tu_ce_dice_bwd(const void* logits, int is_bf16, const uint8_t* target,
                              const float* cw, const float* coefA, const float* coefB,
                              const float* inv_sw, void* dlogits, long long n, int C, int focal,
                              float alpha, float gamma, cudaStream_t stream) {
  return is_bf16 ? bwd<bf16>(logits, target, cw, coefA, coefB, inv_sw, dlogits, n, C, focal,
                             alpha, gamma, stream)
                 : bwd<float>(logits, target, cw, coefA, coefB, inv_sw, dlogits, n, C, focal,
                              alpha, gamma, stream);
}
