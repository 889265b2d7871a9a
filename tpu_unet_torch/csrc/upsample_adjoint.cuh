// The adjoint of the x2 align-corners bilinear upsample of
// NHWC bf16 or float32 tensors, dx (B, H, W, C) from dup (B, 2H, 2W, C):
//   dx[b, i, j, c] = sum_{(u, wr) in R(i)} wr * sum_{(v, wc) in C(j)} wc * dup[b, u, v, c]
// where R(i) / C(j) list the high-resolution rows / columns whose lerp reads
// low-resolution row i / column j, with the forward's bf16-rounded weights
// (host tables from nn/resize.py::adjoint_tables: (n, nr) int32 indices,
// -1 past the end of a list, and float32 weights).
//
// Replaces the dx epilogue of tpu_unet/kernels/decoder_train.py's stage
// backwards: the W- and H-lerp adjoints inside fused_unetup_bwd_paired_impl
// / fused_unetup_bwd_wide_impl (:327-338) and the overlap-add of their
// per-tile dx windows, _overlap_add_windows (the Pallas call at :1208).
// In natural layout there are no windows.
//
// Bound on the H100: bytes (dup read once, dx written once: 0.20 ms for
// up1 at 512x512, batch 8, C 128, at 3.35 TB/s).  Each dup element feeds
// about 2 low-resolution rows and 2 columns, so a gather from device memory
// fetches it about 4 times; this kernel streams it through shared memory
// once and keeps the reuse on the chip.
//
// Design: a block owns one image b, a strip of TW low-resolution columns, a
// chunk of CC channels and a band of TH low-resolution rows (the plan,
// adj::plan, mirrored by kernels/decoder_train.py::adjoint_plan).  Its
// producer warp streams the high-resolution rows u = 2 i0 - 2 .. 2 i1 + 1
// of the band, RPS rows a stage, through a ring of STAGES stages: TMA 4-D
// boxes (CC channels, 2 TW + 4 columns from 2 j0 - 2, RPS rows, 1 image),
// zero-filled out of bounds (no table lists those positions).  A band thus
// re-reads 4 rows at its edges and a strip 4 columns; the strips of a row
// of blocks run side by side, so L2 serves most of the column halo.
// Consumer thread (j, 8 channels), for each row u that arrives:
//   W pass   row = sum over C(j) in table order of fmaf(wc, dup[u, v], row),
//            from zero, the stage in shared memory, C(j) in registers;
//   H pass   for each of u's at most two (i, wr) entries among the band's
//            rows, acc_i = fmaf(wr, row, acc_i), in increasing u (and for
//            one u in table order): two accumulators, for rows r0 and
//            r0 + 1; when u reaches row r0 + 2, row r0 has had its last
//            entry, is rounded to bf16 once and stored (16 bytes).
// Per (i, j, c) that is the gather's float32 operation sequence exactly
// (W pass inside, H pass outside, both in table order, one rounding), so dx
// is bit-identical to the gather form's.  The float32 instantiation (T =
// float: the stages hold float32, a consumer loads its 8 channels as two
// 16-byte chunks, the row is stored unrounded) keeps that order; the plan
// is the same, its stage and shared-memory bytes twice bf16's.  u's entries (the slots) are
// gathered from the row table into shared memory when the block starts.
// No atomics: the result is the same on every run.  Shapes: C % 8 == 0.
//
// Shared by csrc/upsample_adjoint.cu (a decoder stage's dx) and
// csrc/upconv.cu (the up_conv head's dx).
#pragma once

#include "sm90.cuh"

namespace tu {
namespace adj {

constexpr int RPS = 2;               // high-resolution rows a stage
constexpr int STAGES = 4;            // stages of the ring
constexpr int MAXN = 5;              // the longest table row of the x2 lerp
constexpr int MAX_CONSUMERS = 256;   // consumer threads a block
constexpr int MAX_TH = 64;           // band rows
constexpr int MIN_TH = 8;
constexpr int MIN_BLOCKS = 132;      // a block an SM before a band is halved
constexpr int UMAX = 2 * MAX_TH + 4;  // high-resolution rows of a band
constexpr int SLOT_BYTES = UMAX * 2 * 8;  // (row, weight) x 2 a high-resolution row
// the most dynamic shared memory a plan asks for (float32's)
constexpr int SMEM_MAX = STAGES * RPS * (2 * 8 + 4) * 256 * 4 + SLOT_BYTES + 2 * STAGES * 8 + 128;

struct Plan {
  int tw, cc, th, strips, chunks, bands, consumers, stage_bytes, smem;
  long long grid;
};

// TW: the low-resolution columns a strip, a power of two in 8 .. 32;
// CC: the largest power-of-two channel chunk (<= 256) dividing C with at
// most 256 consumer threads; TH: 64 rows, halved (to 8 at least) while the
// grid has fewer blocks than the card has SMs, and at most H; the stage
// bytes for elements of `esize` bytes (2 bf16, 4 float32).
inline Plan plan(int B, int H, int W, int C, int esize = 2) {
  Plan p;
  p.tw = 8;
  while (p.tw < W && p.tw < 32) p.tw *= 2;
  p.cc = 8;
  for (int c = 256; c >= 8; c /= 2)
    if (C % c == 0 && p.tw * (c / 8) <= MAX_CONSUMERS) {
      p.cc = c;
      break;
    }
  p.strips = (W + p.tw - 1) / p.tw;
  p.chunks = C / p.cc;
  p.th = MAX_TH;
  while (p.th > MIN_TH &&
         static_cast<long long>(B) * p.strips * p.chunks * ((H + p.th - 1) / p.th) < MIN_BLOCKS)
    p.th /= 2;
  if (p.th > H) p.th = H;
  p.bands = (H + p.th - 1) / p.th;
  p.consumers = (p.tw * (p.cc / 8) + 31) / 32 * 32;
  p.stage_bytes = RPS * (2 * p.tw + 4) * p.cc * esize;
  p.smem = STAGES * p.stage_bytes + SLOT_BYTES + 2 * STAGES * 8 + 128;
  p.grid = static_cast<long long>(B) * p.bands * p.chunks * p.strips;
  return p;
}

}  // namespace adj

namespace {

using bf16 = __nv_bfloat16;

// the low-resolution row's 8 channels, rounded once to bf16, into dx
__device__ __forceinline__ void store_row(bf16* dst, const float (&acc)[8]) {
  __align__(16) bf16 o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(acc[k]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
}
// float32: stored as they are, two 16-byte chunks
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// 8 channels of a stage row as float32
__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  const uint4 d = *reinterpret_cast<const uint4*>(src);
  const bf16* dv = reinterpret_cast<const bf16*>(&d);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(dv[k]);
}
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(adj::MAX_CONSUMERS + 32)
upsample_adjoint_kernel(const __grid_constant__ CUtensorMap map, const int* __restrict__ ridx,
                        const float* __restrict__ rw, int nr, const int* __restrict__ cidx,
                        const float* __restrict__ cw, int nc, T* __restrict__ dx, int H,
                        int W, int C, int tw, int cc, int th, int strips, int chunks, int bands,
                        int consumers) {
  using namespace tu::sm90;
  using namespace tu::adj;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int cols = 2 * tw + 4;  // high-resolution columns a stage row
  const int stage_bytes = RPS * cols * cc * static_cast<int>(sizeof(T));
  int* slot_i = reinterpret_cast<int*>(smem + STAGES * stage_bytes);
  float* slot_w = reinterpret_cast<float*>(slot_i + 2 * UMAX);
  uint64_t* full = reinterpret_cast<uint64_t*>(slot_w + 2 * UMAX);
  uint64_t* empty = full + STAGES;

  // block -> (strip, chunk, band, image), the strip fastest
  long long bid = blockIdx.x;
  const int strip = static_cast<int>(bid % strips);
  bid /= strips;
  const int chunk = static_cast<int>(bid % chunks);
  bid /= chunks;
  const int band = static_cast<int>(bid % bands);
  const int b = static_cast<int>(bid / bands);
  const int j0 = strip * tw, c0 = chunk * cc, ib0 = band * th;
  const int rows = min(th, H - ib0);
  const int nu = 2 * rows + 4;  // high-resolution rows u0 .. u0 + nu - 1
  const int u0 = 2 * ib0 - 2;
  const int nstage = nu / RPS;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / 32);
    }
    mbar_init_fence();
  }
  for (int k = tid; k < 2 * nu; k += blockDim.x) {
    slot_i[k] = -1;
    slot_w[k] = 0.f;
  }
  __syncthreads();
  // the slots of each u: the band rows' entries (i, a) that list u, in
  // (i, a) order (u's entries in an earlier row come first; an entry of row
  // ib0 - 1 belongs to the band above)
  for (int e = tid; e < rows * nr; e += blockDim.x) {
    const int i = ib0 + e / nr, a = e % nr;
    const int u = ridx[i * nr + a];
    if (u < 0) continue;
    int s = 0;
    for (int a2 = 0; a2 < a; ++a2) s += ridx[i * nr + a2] == u;
    if (i > ib0)
      for (int a2 = 0; a2 < nr; ++a2) s += ridx[(i - 1) * nr + a2] == u;
    const int l = u - u0;
    if (l < 0 || l >= nu || s > 1) __trap();  // not a x2 lerp's table
    slot_i[2 * l + s] = i;
    slot_w[2 * l + s] = rw[i * nr + a];
  }
  __syncthreads();

  if (tid >= consumers) {  // the producer warp: one thread issues every load
    if (tid == consumers) {
      for (int st = 0; st < nstage; ++st) {
        const int s = st % STAGES;
        if (st >= STAGES) mbar_wait(&empty[s], ((st / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], stage_bytes);
        tma_load_4d(smem + s * stage_bytes, &map, &full[s], c0, 2 * j0 - 2, u0 + st * RPS, b);
      }
    }
    return;
  }

  const int c8n = cc / 8;
  const int j = j0 + tid / c8n, c8 = tid % c8n;
  const bool live = tid < tw * c8n && j < W;
  // C(j): column offsets in the stage row (-1 past the list) and weights
  int vq[MAXN];
  float wq[MAXN];
#pragma unroll
  for (int q = 0; q < MAXN; ++q) {
    const int v = live && q < nc ? cidx[j * nc + q] : -1;
    vq[q] = v < 0 ? -1 : (v - (2 * j0 - 2)) * cc;
    wq[q] = v < 0 ? 0.f : cw[j * nc + q];
  }
  T* out = dx + ((static_cast<size_t>(b) * H) * W + j) * C + c0 + c8 * 8;
  const size_t row_stride = static_cast<size_t>(W) * C;
  const int iend = ib0 + rows;

  float acc0[8], acc1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc0[k] = acc1[k] = 0.f;
  int r0 = ib0;
  for (int st = 0; st < nstage; ++st) {
    const int s = st % STAGES;
    mbar_wait(&full[s], (st / STAGES) & 1);
    const T* stage = reinterpret_cast<const T*>(smem + s * stage_bytes) + c8 * 8;
#pragma unroll
    for (int rr = 0; rr < RPS; ++rr) {
      const int l = st * RPS + rr;
      if (slot_i[2 * l] < 0) continue;  // no band row lists u
      const T* src = stage + rr * cols * cc;
      float row[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) row[k] = 0.f;
#pragma unroll
      for (int q = 0; q < MAXN; ++q) {
        if (vq[q] < 0) break;
        float dv[8];
        load8(src + vq[q], dv);
#pragma unroll
        for (int k = 0; k < 8; ++k) row[k] = fmaf(wq[q], dv[k], row[k]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = slot_i[2 * l + e];
        if (i < 0) break;
        const float wr = slot_w[2 * l + e];
        while (i > r0 + 1) {  // row r0 is complete
          if (live) store_row(out + r0 * row_stride, acc0);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            acc0[k] = acc1[k];
            acc1[k] = 0.f;
          }
          ++r0;
        }
        if (i == r0) {
#pragma unroll
          for (int k = 0; k < 8; ++k) acc0[k] = fmaf(wr, row[k], acc0[k]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) acc1[k] = fmaf(wr, row[k], acc1[k]);
        }
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[s]);
  }
  if (live) {
    if (r0 < iend) store_row(out + r0 * row_stride, acc0);
    if (r0 + 1 < iend) store_row(out + (r0 + 1) * row_stride, acc1);
  }
}

// Launch on `stream`; returns the first CUDA error (an invalid shape or
// table width, the tensor map, the launch).
template <typename T>
cudaError_t launch_upsample_adjoint(const T* dup, const int* ridx, const float* rw, int nr,
                                    const int* cidx, const float* cw, int nc, T* dx, int B, int H,
                                    int W, int C, cudaStream_t stream) {
  constexpr int ES = static_cast<int>(sizeof(T));
  using namespace tu::adj;
  if (B < 1 || H < 1 || W < 1 || C < 8 || C % 8 || nr < 1 || nr > MAXN || nc < 1 ||
      nc > MAXN || (reinterpret_cast<uintptr_t>(dup) & 15) || (reinterpret_cast<uintptr_t>(dx) & 15))
    return cudaErrorInvalidValue;
  const Plan p = plan(B, H, W, C, ES);
  if (p.grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(2 * W),
                              static_cast<cuuint64_t>(2 * H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * ES,
                                 static_cast<cuuint64_t>(2 * W) * C * ES,
                                 static_cast<cuuint64_t>(4) * H * W * C * ES};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(p.cc), static_cast<cuuint32_t>(2 * p.tw + 4),
                             static_cast<cuuint32_t>(RPS), 1};
  CUtensorMap m;
  cudaError_t e = sm90::encode_map(
      &m, ES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, dup,
      dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  static bool attr = false;
  if (!attr) {
    e = cudaFuncSetAttribute(upsample_adjoint_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  upsample_adjoint_kernel<T><<<static_cast<unsigned>(p.grid), p.consumers + 32, p.smem, stream>>>(
      m, ridx, rw, nr, cidx, cw, nc, dx, H, W, C, p.tw, p.cc, p.th, p.strips, p.chunks, p.bands,
      p.consumers);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tu
