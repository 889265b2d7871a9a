// Shared 3x3 SAME convolution core for the port's Hopper kernels.
//
// Implicit GEMM over NHWC bf16 activations:
//   out[b, y, x, n] = relu(bias[n] + sum_k A[(b, y, x), k] * Wt[n, k])
// with k = (ky * 3 + kx) * Cin + c and A gathered on the fly by a Loader
// functor (plain NHWC input, the uint8 image with the /255 folded in, or
// the decoder's [skip, up2x(x)] concat that never reaches device memory).
// Weights arrive host-packed as Wt (F, K) bf16, K contiguous.
//
// Tiling: one block = an 8-row x 16-column output tile (128 pixels) x 64
// output channels, 256 threads (8 warps as 4 along M x 2 along N, each
// warp 32 x 32), K staged 32 at a time through shared memory with a
// register prefetch of the next stage.  Products use mma.sync m16n8k16
// bf16 with f32 accumulation.  The epilogue adds the bias, applies ReLU,
// rounds to bf16, stages the tile in shared memory, writes it coalesced
// and, when asked, the 2x2 max-pooled tile as well (the pooled tensor is
// then produced without a second pass over the full one).
//
// Bound on the H100: every conv of the slice is compute-bound at the
// tensor-core rate (about 64-1024 multiply-adds per byte moved).  This
// first design keeps the operands in shared memory and the accumulators
// in registers; it has no TMA, no wgmma and a single stage, so it reaches
// a fraction of the 989 TFLOP/s peak (the chip_smoke.py line records how
// much).  Shapes: H % 8 == 0, W % 16 == 0, F % 64 == 0, K % 32 == 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tu {
namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 8, TW = 16;  // output tile rows x columns
constexpr int BM = TH * TW;     // 128 output pixels per block
constexpr int BN = 64;          // output channels per block
constexpr int BK = 32;          // K per shared-memory stage
constexpr int LDS = BK + 8;     // 80-byte rows: conflict-free fragment loads
constexpr int LDC = BN + 8;     // epilogue staging row stride
constexpr int NT = 256;

struct __align__(16) ConvSmem {
  bf16 a[BM * LDS];  // A tile, pixel-major, K contiguous
  bf16 b[BN * LDS];  // B tile, channel-major, K contiguous
  bf16 c[BM * LDC];  // epilogue staging
};

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Plain NHWC bf16 input with C % 8 == 0: 8 consecutive k never straddle a tap.
struct NhwcLoader {
  const bf16* in;
  int H, W, C;
  __device__ __forceinline__ uint4 operator()(int b, int y, int x, int k) const {
    const int tap = k / C, c = k - tap * C;
    const int iy = y + tap / 3 - 1, ix = x + tap % 3 - 1;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return zero4();
    return *reinterpret_cast<const uint4*>(
        in + ((static_cast<size_t>(b) * H + iy) * W + ix) * C + c);
  }
};

// The 3-channel image (K = 27, padded to 32).  U8: raw uint8, normalised in
// the loader exactly as bf16(bf16(u8) / bf16(255)); else bf16 input as is.
template <bool U8>
struct ImageLoader {
  const void* in;
  int H, W;
  __device__ __forceinline__ uint4 operator()(int b, int y, int x, int k) const {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __float2bfloat16_rn(0.f);
      const int kk = k + j;
      if (kk < 27) {
        const int tap = kk / 3, c = kk - 3 * tap;
        const int iy = y + tap / 3 - 1, ix = x + tap % 3 - 1;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const size_t o = ((static_cast<size_t>(b) * H + iy) * W + ix) * 3 + c;
          if (U8) {
            const float u = static_cast<float>(static_cast<const uint8_t*>(in)[o]);
            v[j] = __float2bfloat16_rn(__fdiv_rn(u, 255.f));
          } else {
            v[j] = static_cast<const bf16*>(in)[o];
          }
        }
      }
    }
    return *reinterpret_cast<const uint4*>(v);
  }
};

// Eight channels [c, c + 8) at output pixel (uy, ux) of the x2
// align-corners bilinear upsample of x (B, H2/2, W2/2, Cx), image b, from
// its four neighbours.  Rounding follows the plain version: the H pass
// rounds to bf16, then the W pass; products and sums are kept unfused
// (__fmul_rn/__fadd_rn) so the result is bit-equal to it.  Row/column
// tables: idx (2, n) int32, w (2, n) f32.
__device__ __forceinline__ uint4 up2x_lerp8(const bf16* x, const int* ridx, const float* rw,
                                            const int* cidx, const float* cw, int H2, int W2,
                                            int Cx, int b, int uy, int ux, int c) {
  const int Hx = H2 / 2, Wx = W2 / 2;
  const int r0 = ridx[uy], r1 = ridx[H2 + uy];
  const float wr0 = rw[uy], wr1 = rw[H2 + uy];
  const int q0 = cidx[ux], q1 = cidx[W2 + ux];
  const float wc0 = cw[ux], wc1 = cw[W2 + ux];
  const bf16* base = x + static_cast<size_t>(b) * Hx * Wx * Cx + c;
  const uint4 u00 = *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(r0) * Wx + q0) * Cx);
  const uint4 u10 = *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(r1) * Wx + q0) * Cx);
  const uint4 u01 = *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(r0) * Wx + q1) * Cx);
  const uint4 u11 = *reinterpret_cast<const uint4*>(base + (static_cast<size_t>(r1) * Wx + q1) * Cx);
  const bf16* v00 = reinterpret_cast<const bf16*>(&u00);
  const bf16* v10 = reinterpret_cast<const bf16*>(&u10);
  const bf16* v01 = reinterpret_cast<const bf16*>(&u01);
  const bf16* v11 = reinterpret_cast<const bf16*>(&u11);
  __align__(16) bf16 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float h0 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
        __fmul_rn(__bfloat162float(v00[j]), wr0), __fmul_rn(__bfloat162float(v10[j]), wr1))));
    const float h1 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
        __fmul_rn(__bfloat162float(v01[j]), wr0), __fmul_rn(__bfloat162float(v11[j]), wr1))));
    o[j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(h0, wc0), __fmul_rn(h1, wc1)));
  }
  return *reinterpret_cast<const uint4*>(o);
}

// operand of a concat [skip | up2x(x)] (the up_conv head backward's dk1
// GEMM, at Cs = 0: csrc/upconv.cu): channel c < Cs from `skip` (B, H2, W2, Cs),
// channel c >= Cs from the x2 upsample of x, lerped as it is gathered
// (up2x_lerp8).
struct UpConcatLoader {
  const bf16* skip;
  const bf16* x;
  const int* ridx;
  const float* rw;
  const int* cidx;
  const float* cw;
  int H2, W2, Cs, Cx;
  __device__ __forceinline__ uint4 operator()(int b, int y, int xo, int k) const {
    const int Cp = Cs + Cx;
    const int tap = k / Cp;
    const int c = k - tap * Cp;
    const int uy = y + tap / 3 - 1, ux = xo + tap % 3 - 1;
    if (uy < 0 || uy >= H2 || ux < 0 || ux >= W2) return zero4();
    if (c < Cs)
      return *reinterpret_cast<const uint4*>(
          skip + ((static_cast<size_t>(b) * H2 + uy) * W2 + ux) * Cs + c);
    return up2x_lerp8(x, ridx, rw, cidx, cw, H2, W2, Cx, b, uy, ux, c - Cs);
  }
};

// Backward of a UnetUp stage (csrc/decoder_train.cu): the dgrad operand of
// conv2, g2 = g * [out > 0], masked as it is gathered.  The centre tap of
// the blocks with blockIdx.y == 0 also stores g2, so every (pixel,
// channel) of it is written exactly once.
struct ReluGradLoader {
  const bf16* g;
  const bf16* out;
  bf16* g2;
  int H, W, C;
  __device__ __forceinline__ uint4 operator()(int b, int y, int x, int k) const {
    const int tap = k / C, c = k - tap * C;
    const int iy = y + tap / 3 - 1, ix = x + tap % 3 - 1;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return zero4();
    const size_t o = ((static_cast<size_t>(b) * H + iy) * W + ix) * C + c;
    const uint4 gu = *reinterpret_cast<const uint4*>(g + o);
    const uint4 ou = *reinterpret_cast<const uint4*>(out + o);
    const bf16* gv = reinterpret_cast<const bf16*>(&gu);
    const bf16* ov = reinterpret_cast<const bf16*>(&ou);
    __align__(16) bf16 r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      r[j] = __bfloat162float(ov[j]) > 0.f ? gv[j] : __float2bfloat16_rn(0.f);
    const uint4 ru = *reinterpret_cast<const uint4*>(r);
    if (tap == 4 && blockIdx.y == 0) *reinterpret_cast<uint4*>(g2 + o) = ru;
    return ru;
  }
};

// The implicit-GEMM main loop shared by every conv kernel: acc (the warp's
// 32 x 32 sub-tile, mma.sync fragment layout) = A(block's 128 pixels, K) *
// Wt(n0 .. n0 + 63, K)^T.
template <class Loader>
__device__ __forceinline__ void conv_mainloop(const Loader& ld, const bf16* __restrict__ wt,
                                              ConvSmem& s, float (&acc)[2][4][4], int b,
                                              int y0, int x0, int n0, int K) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  uint4 ra[2], rb;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * NT, p = v >> 2, sub = v & 3;
      ra[i] = ld(b, y0 + p / TW, x0 + p % TW, k0 + sub * 8);
    }
    rb = *reinterpret_cast<const uint4*>(
        wt + static_cast<size_t>(n0 + (tid >> 2)) * K + k0 + (tid & 3) * 8);
  };

  const int nk = K / BK;
  fetch(0);
  for (int kc = 0; kc < nk; ++kc) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * NT;
      *reinterpret_cast<uint4*>(&s.a[(v >> 2) * LDS + (v & 3) * 8]) = ra[i];
    }
    *reinterpret_cast<uint4*>(&s.b[(tid >> 2) * LDS + (tid & 3) * 8]) = rb;
    __syncthreads();
    if (kc + 1 < nk) fetch((kc + 1) * BK);  // next stage's loads in flight
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* pa = &s.a[(wm * 32 + mi * 16 + g) * LDS + ks + 2 * t];
        af[mi][0] = lds32(pa);
        af[mi][1] = lds32(pa + 8 * LDS);
        af[mi][2] = lds32(pa + 8);
        af[mi][3] = lds32(pa + 8 * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* pb = &s.b[(wn * 32 + ni * 8 + g) * LDS + ks + 2 * t];
        bfr[ni][0] = lds32(pb);
        bfr[ni][1] = lds32(pb + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }
}

template <class Loader, bool POOL>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(Loader ld, const bf16* __restrict__ wt, const float* __restrict__ bias,
               bf16* __restrict__ out, bf16* __restrict__ pooled, int H, int W, int K,
               int F) {
  __shared__ ConvSmem s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_w = W / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;

  float acc[2][4][4];
  conv_mainloop(ld, wt, s, acc, b, y0, x0, n0, K);

  // epilogue: bias + ReLU, bf16, staged in shared memory
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 32 + mi * 16 + g, c = wn * 32 + ni * 8 + 2 * t;
      const float bb0 = bias[n0 + c], bb1 = bias[n0 + c + 1];
      *reinterpret_cast<__nv_bfloat162*>(&s.c[r * LDC + c]) = __floats2bfloat162_rn(
          fmaxf(acc[mi][ni][0] + bb0, 0.f), fmaxf(acc[mi][ni][1] + bb1, 0.f));
      *reinterpret_cast<__nv_bfloat162*>(&s.c[(r + 8) * LDC + c]) = __floats2bfloat162_rn(
          fmaxf(acc[mi][ni][2] + bb0, 0.f), fmaxf(acc[mi][ni][3] + bb1, 0.f));
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = tid + i * NT, p = v >> 3, sub = v & 7;
    const int y = y0 + p / TW, x = x0 + p % TW;
    *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * H + y) * W + x) * F + n0 + sub * 8) =
        *reinterpret_cast<const uint4*>(&s.c[p * LDC + sub * 8]);
  }
  if (POOL) {
    const int p2 = tid >> 3, sub = tid & 7, py = p2 >> 3, px = p2 & 7;
    const bf16* c00 = &s.c[((2 * py) * TW + 2 * px) * LDC + sub * 8];
    const __nv_bfloat162* q00 = reinterpret_cast<const __nv_bfloat162*>(c00);
    const __nv_bfloat162* q01 = reinterpret_cast<const __nv_bfloat162*>(c00 + LDC);
    const __nv_bfloat162* q10 = reinterpret_cast<const __nv_bfloat162*>(c00 + TW * LDC);
    const __nv_bfloat162* q11 = reinterpret_cast<const __nv_bfloat162*>(c00 + TW * LDC + LDC);
    __align__(16) __nv_bfloat162 m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = __hmax2(__hmax2(q00[j], q01[j]), __hmax2(q10[j], q11[j]));
    const int Hp = H / 2, Wp = W / 2;
    *reinterpret_cast<uint4*>(pooled + ((static_cast<size_t>(b) * Hp + y0 / 2 + py) * Wp + x0 / 2 + px) * F +
                              n0 + sub * 8) = *reinterpret_cast<const uint4*>(m);
  }
}

// Launch one conv on `stream`; returns cudaGetLastError().
template <class Loader, bool POOL>
cudaError_t launch_conv3x3(const Loader& ld, const bf16* wt, const float* bias, bf16* out,
                           bf16* pooled, int B, int H, int W, int K, int F,
                           cudaStream_t stream) {
  const dim3 grid((H / TH) * (W / TW), F / BN, B);
  conv3x3_kernel<Loader, POOL><<<grid, NT, 0, stream>>>(ld, wt, bias, out, pooled, H, W, K, F);
  return cudaGetLastError();
}

// Epilogues of the gradient convs: no bias, no ReLU, the f32 sums rounded
// to bf16, then
//   EPI_MASK:  out = v * [mask > 0], mask laid out as out (F channels);
//   EPI_SPLIT: channels [0, Fa) to out (Fa channels a pixel), [Fa, F) to
//              out2 (F - Fa channels a pixel); Fa % 8 == 0.
enum { EPI_MASK = 0, EPI_SPLIT = 1 };

template <class Loader, int EPI>
__global__ void __launch_bounds__(NT)
conv3x3_grad_kernel(Loader ld, const bf16* __restrict__ wt, const bf16* __restrict__ mask,
                    bf16* __restrict__ out, bf16* __restrict__ out2, int H, int W, int K,
                    int F, int Fa) {
  __shared__ ConvSmem s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_w = W / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;

  float acc[2][4][4];
  conv_mainloop(ld, wt, s, acc, b, y0, x0, n0, K);

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 32 + mi * 16 + g, c = wn * 32 + ni * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(&s.c[r * LDC + c]) =
          __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<__nv_bfloat162*>(&s.c[(r + 8) * LDC + c]) =
          __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = tid + i * NT, p = v >> 3, sub = v & 7;
    const size_t pix = (static_cast<size_t>(b) * H + y0 + p / TW) * W + x0 + p % TW;
    const int n = n0 + sub * 8;
    uint4 val = *reinterpret_cast<const uint4*>(&s.c[p * LDC + sub * 8]);
    if (EPI == EPI_MASK) {
      const uint4 mu = *reinterpret_cast<const uint4*>(mask + pix * F + n);
      const bf16* mv = reinterpret_cast<const bf16*>(&mu);
      bf16* vv = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!(__bfloat162float(mv[j]) > 0.f)) vv[j] = __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(out + pix * F + n) = val;
    } else if (n < Fa) {
      *reinterpret_cast<uint4*>(out + pix * Fa + n) = val;
    } else {
      *reinterpret_cast<uint4*>(out2 + pix * (F - Fa) + (n - Fa)) = val;
    }
  }
}

// Launch one gradient conv on `stream` (F output channels); returns
// cudaGetLastError().
template <class Loader, int EPI>
cudaError_t launch_conv3x3_grad(const Loader& ld, const bf16* wt, const bf16* mask, bf16* out,
                                bf16* out2, int B, int H, int W, int K, int F, int Fa,
                                cudaStream_t stream) {
  const dim3 grid((H / TH) * (W / TW), F / BN, B);
  conv3x3_grad_kernel<Loader, EPI><<<grid, NT, 0, stream>>>(ld, wt, mask, out, out2, H, W, K,
                                                            F, Fa);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tu
