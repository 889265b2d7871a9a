// The canonical UNets' serving tail at F = 64 features: the final 1x1 conv
// (64 -> C), per-pixel argmax and uint8 mask, with or without the
// per-image class histogram; the logits never reach device memory.
//
// Replaces tpu_unet/kernels/postprocess.py::fused_final_argmax_hist_paired
// (the Pallas call at :244), the tail of unet_vgg and unet_resnet50, and,
// at F = 64, fused_final_argmax (:92), the mask-only tail that :148-152
// takes when an image's pixel count is not a multiple of the row block.
// Reached from csrc/postprocess.cu's C entries (tu_final_argmax_hist,
// tu_final_argmax), which keep F = 22 and 32 on their own template.
//
// Bound on the H100: bytes (reading the bf16 features, 268 MB at 8 x 512^2
// x 64: 0.080 ms at 3.35 TB/s; the mask adds 2 MB).  The products (5.6
// GFLOP at C = 21) take 0.084 ms on the float32 pipes, so, as the TPU
// kernel runs them on its matrix unit (a bf16 dot with float32 sums), they
// run on wgmma, where they cost ~0.006 ms.
//
// Design (the front half of the fused loss's ring, csrc/loss.cu): a
// persistent grid of at most CTAS blocks; block g takes the 128-pixel
// tiles [T g / G, T (g + 1) / G), a contiguous range.  Its producer warp
// issues TMA loads of each tile (128 pixels x 64 bf16 features, rows of
// 128 bytes 128-byte swizzled, the layout wgmma reads; rows past n arrive
// as zeros) into a ring of STAGES stages.  Consumer warpgroups 0 and 1
// take 64 pixels each:
//   logits   wgmma m64nNPk16 x 4, NP = C rounded up to 8; W (NP rows of 64
//            bf16, zero past C; the float32 weights rounded to bf16, as the
//            TPU kernel casts them to the feature dtype) staged once a block
//            as the B operand; the stage is released once the product is in;
//            the float32 bias added to the float32 sums, -inf on a padded
//            column;
//   argmax   over the columns a thread holds in increasing order (strict >,
//            the first maximum), then across the quad of lanes that holds a
//            row, a larger value or an equal one of a lower class winning:
//            the first maximum, as torch.argmax and jnp.argmax keep it;
//   mask     one byte a pixel into shared memory (two buffers), then 16-byte
//            stores of the warpgroup's 64 bytes (bytes, and none past n, on
//            the ragged last tile);
//   hist     shared-memory int32 counts of the current image (a tile never
//            spans two images: the histogram call takes H*W % 256 == 0),
//            flushed with one global atomicAdd a class when the block's next
//            tile is in another image and at its end.
// Integer counts and one product order: the same result on every run.
// bf16 x bf16 products are exact in float32, so the logits differ from the
// plain version's float32 sums only in the order of the sums (and in the
// weights' rounding where they are not bf16 already): masks can flip only
// at near-ties.  Limits: 1 <= C <= 32.
#include "sm90.cuh"

namespace {

using namespace tu::sm90;
using bf16 = __nv_bfloat16;

constexpr int CF = 64;            // features
constexpr int TILE = 128;         // pixels a tile: 64 a consumer warpgroup
constexpr int FT = TILE * CF * 2;  // bytes a tile
constexpr int CTAS = 132;         // the most blocks
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 8;
constexpr int MAXC = 32;
// shared memory: the ring, W (NP <= 32 rows of 128 bytes), the bias, the
// counts, two mask buffers, the barriers
constexpr int W_OFF = STAGES * FT;
constexpr int B_OFF = W_OFF + MAXC * 128;
constexpr int H_OFF = B_OFF + MAXC * 4;
constexpr int M_OFF = H_OFF + MAXC * 4;
constexpr int BAR_OFF = M_OFF + 2 * TILE;
constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;

// byte offset of element (r, k) of a 128-byte-swizzled tile of 64-wide
// bf16 rows, as TMA writes CU_TENSOR_MAP_SWIZZLE_128B
__device__ __forceinline__ int sw128(int r, int k) {
  return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + ((k & 7) << 1);
}

// the better of (v, c) and lane ^ o's: the larger value, or the lower class
// of equal values
__device__ __forceinline__ void quad_best(float& v, int& c, int o) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, o);
  const int oc = __shfl_xor_sync(0xffffffffu, c, o);
  if (ov > v || (ov == v && oc < c)) {
    v = ov;
    c = oc;
  }
}

template <int NP, bool HIST>
__global__ void __launch_bounds__(THREADS, 1)
final_tail_kernel(const __grid_constant__ CUtensorMap fmap, const float* __restrict__ w,
                  const float* __restrict__ bias, uint8_t* __restrict__ mask,
                  int* __restrict__ hist, int n, int per_img, int C) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Wt = smem + W_OFF;
  float* sb = reinterpret_cast<float*>(smem + B_OFF);
  int* sh = reinterpret_cast<int*>(smem + H_OFF);
  uint8_t* sm = smem + M_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int ntiles = (n + TILE - 1) / TILE;
  const int t0 = static_cast<int>(static_cast<long long>(ntiles) * blockIdx.x / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(ntiles) * (blockIdx.x + 1) / gridDim.x);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  if (tid < CONSUMERS) {
    // W as the B operand: NP rows (classes) of 64 bf16, zero past C; w is
    // (64, C) float32
    for (int i = tid; i < NP * CF; i += CONSUMERS) {
      const int c = i / CF, k = i - c * CF;
      *reinterpret_cast<bf16*>(Wt + sw128(c, k)) = __float2bfloat16_rn(c < C ? w[k * C + c] : 0.f);
    }
    if (tid < MAXC) {
      sb[tid] = tid < C ? bias[tid] : -INFINITY;
      sh[tid] = 0;
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every load
    if (tid == CONSUMERS) {
      int it = 0;
      for (int t = t0; t < t1; ++t, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], FT);
        tma_load_2d(smem + s * FT, &fmap, &full[s], 0, t * TILE);
      }
    }
    return;
  }

  const int wg = tid >> 7, lt = tid & 127, warp = lt >> 5, lane = tid & 31;
  const int q = lane & 3, lr = warp * 16 + (lane >> 2);  // rows lr, lr + 8 of the warpgroup's 64
  const uint64_t dw = desc_sw128(Wt, 16, 1024);
  // the bias of the columns this thread holds: 8j + 2q + e
  float bq[NP / 4];
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bq[2 * j + e] = sb[8 * j + 2 * q + e];

  int it = 0;
  for (int t = t0; t < t1; ++t, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    float x[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) x[i] = 0.f;
    const uint64_t dfa = desc_sw128(smem + s * FT + wg * (FT / 2), 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < CF / 16; ++k) wgmma<NP, 0, 0>(x, dfa + 2 * k, dw + 2 * k, k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(x);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage is free

    // x[4j + e]: row lr, column 8j + 2q + e; x[4j + 2 + e]: row lr + 8
    float v0 = -INFINITY, v1 = -INFINITY;
    int c0 = 0, c1 = 0;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e;
        const float a0 = x[4 * j + e] + bq[2 * j + e], a1 = x[4 * j + 2 + e] + bq[2 * j + e];
        if (a0 > v0) {
          v0 = a0;
          c0 = c;
        }
        if (a1 > v1) {
          v1 = a1;
          c1 = c;
        }
      }
    quad_best(v0, c0, 1);
    quad_best(v0, c0, 2);
    quad_best(v1, c1, 1);
    quad_best(v1, c1, 2);

    const int p64 = t * TILE + wg * 64;  // the warpgroup's first pixel
    uint8_t* mb = sm + (it & 1) * TILE + wg * 64;
    if (q == 0) {
      mb[lr] = static_cast<uint8_t>(c0);
      mb[lr + 8] = static_cast<uint8_t>(c1);
      if constexpr (HIST) {
        atomicAdd(&sh[c0], 1);
        atomicAdd(&sh[c1], 1);
      }
    }
    bar_sync(1 + wg, 128);
    if (p64 + 64 <= n) {
      if (lt < 4)
        reinterpret_cast<uint4*>(mask + p64)[lt] = reinterpret_cast<const uint4*>(mb)[lt];
    } else if (lt < 64 && p64 + lt < n) {
      mask[p64 + lt] = mb[lt];
    }
    if constexpr (HIST) {
      const int img = t * TILE / per_img;
      if (t + 1 == t1 || (t + 1) * TILE / per_img != img) {
        bar_sync(3, CONSUMERS);  // every count of the image is in
        if (tid < C) {
          const int v = sh[tid];
          if (v) atomicAdd(&hist[img * C + tid], v);
          sh[tid] = 0;
        }
        bar_sync(3, CONSUMERS);
      }
    }
  }
}

// A (n, 64) bf16 map of 128-pixel boxes, 128-byte swizzled
cudaError_t feature_map(CUtensorMap* m, const void* base, int n) {
  const cuuint64_t d[2] = {CF, static_cast<cuuint64_t>(n)};
  const cuuint64_t st[1] = {CF * 2};
  const cuuint32_t box[2] = {CF, TILE};
  return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, d, st, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NP, bool HIST>
cudaError_t launch_np(const CUtensorMap& m, const float* w, const float* bias, uint8_t* mask,
                      int* hist, int n, int per_img, int C, int grid, cudaStream_t stream) {
  auto kernel = final_tail_kernel<NP, HIST>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DYN);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  kernel<<<grid, THREADS, DYN, stream>>>(m, w, bias, mask, hist, n, per_img, C);
  return cudaGetLastError();
}

template <bool HIST>
cudaError_t launch(const CUtensorMap& m, const float* w, const float* bias, uint8_t* mask,
                   int* hist, int n, int per_img, int C, int np, int grid, cudaStream_t stream) {
  switch (np) {
    case 8: return launch_np<8, HIST>(m, w, bias, mask, hist, n, per_img, C, grid, stream);
    case 16: return launch_np<16, HIST>(m, w, bias, mask, hist, n, per_img, C, grid, stream);
    case 24: return launch_np<24, HIST>(m, w, bias, mask, hist, n, per_img, C, grid, stream);
    case 32: return launch_np<32, HIST>(m, w, bias, mask, hist, n, per_img, C, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace tu {

// feats (n, 64) bf16, w (64, C) and bias (C) float32, mask (n) uint8, hist
// (n / per_img, C) int32 zeroed (with_hist; per_img % TILE == 0) or null.
// The plan (kernels/postprocess.py::tail_plan): NP = C rounded up to 8,
// grid = the tiles, at most CTAS.
int launch_final_tail(const bf16* feats, const float* w, const float* bias, uint8_t* mask,
                      int* hist, int n, int per_img, int C, bool with_hist,
                      cudaStream_t stream) {
  if (n < 1 || C < 1 || C > MAXC || (with_hist && (per_img < 1 || per_img % TILE || n % per_img)) ||
      (reinterpret_cast<uintptr_t>(feats) & 15) || (reinterpret_cast<uintptr_t>(mask) & 15))
    return cudaErrorInvalidValue;
  const int tiles = (n + TILE - 1) / TILE;
  const int grid = tiles < CTAS ? tiles : CTAS;
  const int np = (C + 7) / 8 * 8;
  CUtensorMap m;
  const cudaError_t e = feature_map(&m, feats, n);
  if (e != cudaSuccess) return e;
  return with_hist ? launch<true>(m, w, bias, mask, hist, n, per_img, C, np, grid, stream)
                   : launch<false>(m, w, bias, mask, nullptr, n, 1, C, np, grid, stream);
}

}  // namespace tu
