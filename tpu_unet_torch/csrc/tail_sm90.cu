// The serving tails: the final 1x1 conv (F -> C), per-pixel argmax and
// uint8 mask, with or without the per-image class histogram; the logits
// never reach device memory.  One kernel template on the feature width F
// (22, 32 or 64), the padded class count NP and the histogram.
//
// Replaces three functions of tpu_unet/kernels/postprocess.py:
//   - fused_final_argmax_hist_paired (the Pallas call at :244), the tail of
//     unet_vgg and unet_resnet50, F = 64;
//   - fused_final_argmax_hist (:154), the natural-layout tail of the
//     TraditionalUnet family, F = 32 (traditional) and 22 (traditional22);
//   - fused_final_argmax (:92), the mask-only tail that :148-152 takes when
//     an image's pixel count is not a multiple of the row block, at every F.
// Reached from csrc/postprocess.cu's C entries (tu_final_argmax_hist,
// tu_final_argmax).
//
// Bound on the H100: bytes (reading the bf16 features: 268 MB at 8 x 512^2
// x 64, 0.080 ms at 3.35 TB/s; 134 MB at 32 x 256^2 x 32, 0.040 ms; 92 MB
// at F = 22, 0.028 ms; the mask adds a byte a pixel).  The products (5.6
// GFLOP at 8 x 512^2 x 64 -> 21) would take 0.084 ms on the float32 pipes,
// and at C = 21-32 the natural widths' float32 dot products made the old
// one-thread-a-pixel kernel bound by instructions; as the TPU kernels run
// them on their matrix unit (a bf16 dot with float32 sums), they run on
// wgmma, where they cost a few microseconds.
//
// Design (the front half of the fused loss's ring, csrc/loss.cu): a
// persistent grid of at most CTAS blocks; block g takes the tiles
// [T g / G, T (g + 1) / G), a contiguous range.  A tile is 64 pixels a
// consumer warpgroup: 128 pixels (two warpgroups, one block an SM) at F =
// 64; 256 (four warpgroups, two blocks an SM) at F = 22 and 32, whose
// pixels carry fewer bytes, so that more tiles are worked on at once for
// the bytes in flight (at F = 22 one block an SM reached about half the
// bound: the consumers' work a pixel, not the bytes).  One producer thread
// initialises the barriers and issues the first round of loads before the
// consumers stage W, then keeps a ring of STAGES stages full:
//   F = 64   TMA 2-D loads of 128 x 64 bf16, rows of 128 bytes 128-byte
//            swizzled, the layout wgmma reads A from (rows past n arrive as
//            zeros);
//   F = 22, 32  1-D bulk copies of the tile's contiguous rows (a row of 44
//            bytes has no 16-byte stride, so no tensor map exists at F =
//            22; F = 32 takes the same path).  A ragged last tile (mask
//            only) copies its bytes rounded down to 16; its consumers read
//            the rest, at most three words, in device memory.
// Consumer warpgroups take 64 pixels each:
//   logits   wgmma m64nNPk16, NP = C rounded up to 8, float32 sums: at F =
//            64 four k16 steps with A from the stage; at F = 22 and 32 two
//            steps with A from registers, each thread loading its two rows'
//            words from the stage (one 16-byte load a row at F = 32; three
//            words a row at F = 22, rows of 11 words, an odd count, so the
//            lanes' banks collide at most twice).  The feature behind each
//            K column follows the words a thread loads (tail_feature; the
//            host mirror is kernels/postprocess.py::tail_k_order); columns
//            that no feature fills are zero in A and W.  W (NP rows of the
//            K columns, zero past C; the float32 weights rounded to bf16,
//            as the TPU kernel casts them to the feature dtype) is staged
//            once a block as the B operand; a stage is released once its
//            rows are read (registers) or the product is in (F = 64); the
//            float32 bias added to the float32 sums, -inf on a padded
//            column;
//   argmax   over the columns a thread holds in increasing order (strict >,
//            the first maximum), then across the quad of lanes that holds a
//            row, a larger value or an equal one of a lower class winning:
//            the first maximum, as torch.argmax and jnp.argmax keep it;
//   mask     one byte a pixel into shared memory (two buffers), then 16-byte
//            stores of the warpgroup's 64 bytes (bytes, and none past n, on
//            the ragged last tile);
//   hist     shared-memory int32 counts of the current image (a tile never
//            spans two images: the histogram call takes H*W % TILE == 0),
//            flushed with one global atomicAdd a class when the block's next
//            tile is in another image and at its end.
// Integer counts and one product order: the same result on every run.
// bf16 x bf16 products are exact in float32, so the logits differ from the
// plain version's float32 sums only in the order of the sums (and in the
// weights' rounding where they are not bf16 already): masks can flip only
// at near-ties.  Shared memory is addressed from the extern array itself
// (a pointer rounded through an integer would make every access generic).
// Limits: 1 <= C <= 32.
#include "sm90.cuh"

namespace {

using namespace tu::sm90;
using bf16 = __nv_bfloat16;

constexpr int SMS = 132;   // the H100's SMs
constexpr int MAXC = 32;
constexpr int KN = 32;     // K columns at F = 22 and 32: two k16 steps

// The geometry at feature width F.  Shared memory: the ring, W (NP <= 32
// rows of 128 bytes, 128-byte swizzled), the bias, the counts, two mask
// buffers, the barriers.
template <int F>
struct Geo {
  static constexpr int WGS = F == 64 ? 2 : 4;          // consumer warpgroups
  static constexpr int TILE = 64 * WGS;                // pixels a tile
  static constexpr int FT = TILE * F * 2;              // bytes a tile
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;       // and one producer warp
  static constexpr int MINB = F == 64 ? 1 : 2;         // blocks an SM
  static constexpr int CTAS = SMS * MINB;              // the most blocks
  static constexpr int STAGES = F == 32 ? 6 : 8;       // two rings fit an SM at F = 22 / 32
  static constexpr int W_OFF = STAGES * FT;
  static constexpr int B_OFF = W_OFF + MAXC * 128;
  static constexpr int H_OFF = B_OFF + MAXC * 4;
  static constexpr int M_OFF = H_OFF + MAXC * 4;
  static constexpr int BAR_OFF = M_OFF + 2 * TILE;
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8;
  static constexpr int FLUSH_BAR = 1 + WGS;            // named barrier ids 1..WGS: a warpgroup's
  static_assert(W_OFF % 1024 == 0 && BAR_OFF % 8 == 0, "shared-memory layout");
};

// byte offset of element (r, k) of a 128-byte-swizzled tile of 64-wide
// bf16 rows, as TMA writes CU_TENSOR_MAP_SWIZZLE_128B
__device__ __forceinline__ int sw128(int r, int k) {
  return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + ((k & 7) << 1);
}

// At F = 22 and 32: the word of its row (features 2 word, 2 word + 1) that
// a thread of quad lane q puts in A slot m (k16 step m / 2; registers 0 / 1
// at m even, 2 / 3 at m odd), or -1 for a zero.  F = 32: the 16-byte run
// 4q .. 4q + 3; F = 22: 3q .. 3q + 2 below 11.
template <int F>
__host__ __device__ constexpr int tail_word(int q, int m) {
  return F == 32 ? 4 * q + m : (m < 3 && 3 * q + m < F / 2 ? 3 * q + m : -1);
}

// the feature behind K column k (0 .. KN - 1), or -1 where A holds a zero
template <int F>
__host__ __device__ constexpr int tail_feature(int k) {
  const int s = k / 16, c = k % 16, q = (c % 8) / 2, e = c % 2, h = c / 8;
  const int word = tail_word<F>(q, 2 * s + h);
  return word < 0 ? -1 : 2 * word + e;
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

// F = 22 / 32: the A fragments of both k16 steps for rows r and r + 8 of
// the tile (quad lane q) from the staged rows; in a ragged last tile (RG)
// a row at or past `rows` is zero and a word at or past `limw` (the copy's
// end) is read from g, the tile's rows in device memory.
template <int F, bool RG>
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const uint8_t* stage,
                                       const uint32_t* __restrict__ g, int r, int q, int rows,
                                       int limw) {
  if constexpr (F == 32) {
    uint4 v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      v[h] = !RG || rr < rows ? reinterpret_cast<const uint4*>(stage + rr * 64)[q]
                              : make_uint4(0u, 0u, 0u, 0u);
    }
    a[0][0] = v[0].x, a[0][1] = v[1].x, a[0][2] = v[0].y, a[0][3] = v[1].y;
    a[1][0] = v[0].z, a[1][1] = v[1].z, a[1][2] = v[0].w, a[1][3] = v[1].w;
  } else {
    constexpr int FW = F / 2;
    const uint32_t* st = reinterpret_cast<const uint32_t*>(stage);
    uint32_t u[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int word = tail_word<F>(q, m), rr = r + 8 * h, i = rr * FW + word;
        if (word < 0)
          u[h][m] = 0u;
        else if constexpr (RG)
          u[h][m] = i < limw ? st[i] : rr < rows ? g[i] : 0u;
        else
          u[h][m] = st[i];
      }
    a[0][0] = u[0][0], a[0][1] = u[1][0], a[0][2] = u[0][1], a[0][3] = u[1][1];
    a[1][0] = u[0][2], a[1][1] = u[1][2], a[1][2] = 0u, a[1][3] = 0u;
  }
}

template <int F, int NP, bool HIST>
__global__ void __launch_bounds__(Geo<F>::THREADS, Geo<F>::MINB)
final_tail_kernel(const __grid_constant__ CUtensorMap fmap, const bf16* __restrict__ feats,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  uint8_t* __restrict__ mask, int* __restrict__ hist, int n, int per_img, int C) {
  using G = Geo<F>;
  constexpr int TILE = G::TILE, FT = G::FT, CONSUMERS = G::CONSUMERS, STAGES = G::STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* Wt = smem + G::W_OFF;
  float* sb = reinterpret_cast<float*>(smem + G::B_OFF);
  int* sh = reinterpret_cast<int*>(smem + G::H_OFF);
  uint8_t* sm = smem + G::M_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int ntiles = (n + TILE - 1) / TILE;
  const int t0 = static_cast<int>(static_cast<long long>(ntiles) * blockIdx.x / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(ntiles) * (blockIdx.x + 1) / gridDim.x);

  // tile t's load into stage s
  auto issue = [&](int t, int s) {
    if constexpr (F == 64) {
      mbar_expect_tx(&full[s], FT);
      tma_load_2d(smem + s * FT, &fmap, &full[s], 0, t * TILE);
    } else {
      const long long p0 = static_cast<long long>(t) * TILE;
      const int rows = n - p0 < TILE ? static_cast<int>(n - p0) : TILE;
      const uint32_t lb = static_cast<uint32_t>(rows * F * 2) & ~15u;
      mbar_expect_tx(&full[s], lb);
      if (lb) bulk_load(smem + s * FT, feats + p0 * F, lb, &full[s]);
    }
  };
  // the producer thread: the barriers, then the first round of loads, in
  // flight while the consumers stage W
  const int first = t1 - t0 < STAGES ? t1 - t0 : STAGES;
  if (tid == CONSUMERS) {
    if (smem_addr(smem) & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init_fence();
    for (int i = 0; i < first; ++i) issue(t0 + i, i);
  }
  if (tid < CONSUMERS) {
    // W as the B operand: NP rows (classes) of K columns, zero past C; w
    // is (F, C) float32
    if constexpr (F == 64) {
      for (int i = tid; i < NP * F; i += CONSUMERS) {
        const int c = i / F, k = i - c * F;
        *reinterpret_cast<bf16*>(Wt + sw128(c, k)) =
            __float2bfloat16_rn(c < C ? w[k * C + c] : 0.f);
      }
    } else {
      for (int i = tid; i < NP * KN; i += CONSUMERS) {
        const int c = i / KN, k = i - c * KN, f = tail_feature<F>(k);
        *reinterpret_cast<bf16*>(Wt + sw128(c, k)) =
            __float2bfloat16_rn(c < C && f >= 0 ? w[f * C + c] : 0.f);
      }
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
      int s = first % STAGES;
      uint32_t phase = 0;  // of the round the stage's last load belongs to
      for (int t = t0 + first; t < t1; ++t) {
        mbar_wait(&empty[s], phase);  // the consumers are done with round `phase`
        issue(t, s);
        if (++s == STAGES) s = 0, phase ^= 1;
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

  // the histogram's image: tiles_per_img tiles an image, the current one and
  // the tile that starts the next (no division in the loop)
  [[maybe_unused]] const int tiles_per_img = HIST ? per_img / TILE : 1;
  [[maybe_unused]] int img = HIST ? t0 / tiles_per_img : 0;
  [[maybe_unused]] int next_img = (img + 1) * tiles_per_img;
  int s = 0, buf = 0;
  uint32_t phase = 0;
  for (int t = t0; t < t1; ++t) {
    mbar_wait(&full[s], phase);
    float x[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) x[i] = 0.f;
    if constexpr (F == 64) {
      const uint64_t dfa = desc_sw128(smem + s * FT + wg * (FT / 2), 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < F / 16; ++k) wgmma<NP, 0, 0>(x, dfa + 2 * k, dw + 2 * k, k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(x);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage is free
    } else {
      const long long p0 = static_cast<long long>(t) * TILE;
      const int rows = n - p0 < TILE ? static_cast<int>(n - p0) : TILE;
      uint32_t a[2][4];
      if (rows == TILE) {
        load_a<F, false>(a, smem + s * FT, nullptr, wg * 64 + lr, q, TILE, 0);
      } else {
        const uint32_t* g = reinterpret_cast<const uint32_t*>(feats + p0 * F);
        load_a<F, true>(a, smem + s * FT, g, wg * 64 + lr, q, rows, (rows * F * 2 & ~15) / 4);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage is free
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k) wgmma_rs<NP, 0>(x, a[k], dw + 2 * k, k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(x);
    }

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
    uint8_t* mb = sm + buf * TILE + wg * 64;
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
      if (t + 1 == t1 || t + 1 == next_img) {
        bar_sync(G::FLUSH_BAR, CONSUMERS);  // every count of the image is in
        if (tid < C) {
          const int v = sh[tid];
          if (v) atomicAdd(&hist[img * C + tid], v);
          sh[tid] = 0;
        }
        bar_sync(G::FLUSH_BAR, CONSUMERS);
        ++img;
        next_img += tiles_per_img;
      }
    }
    buf ^= 1;
    if (++s == STAGES) s = 0, phase ^= 1;
  }
}

// A (n, 64) bf16 map of 128-pixel boxes, 128-byte swizzled
cudaError_t feature_map(CUtensorMap* m, const void* base, int n) {
  const cuuint64_t d[2] = {64, static_cast<cuuint64_t>(n)};
  const cuuint64_t st[1] = {64 * 2};
  const cuuint32_t box[2] = {64, Geo<64>::TILE};
  return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, d, st, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int F, int NP, bool HIST>
cudaError_t launch_np(const CUtensorMap& m, const bf16* feats, const float* w, const float* bias,
                      uint8_t* mask, int* hist, int n, int per_img, int C, int grid,
                      cudaStream_t stream) {
  auto kernel = final_tail_kernel<F, NP, HIST>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<F>::DYN);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  kernel<<<grid, Geo<F>::THREADS, Geo<F>::DYN, stream>>>(m, feats, w, bias, mask, hist, n,
                                                         per_img, C);
  return cudaGetLastError();
}

template <int F, bool HIST>
cudaError_t launch(const CUtensorMap& m, const bf16* feats, const float* w, const float* bias,
                   uint8_t* mask, int* hist, int n, int per_img, int C, int np, int grid,
                   cudaStream_t stream) {
  switch (np) {
    case 8: return launch_np<F, 8, HIST>(m, feats, w, bias, mask, hist, n, per_img, C, grid, stream);
    case 16: return launch_np<F, 16, HIST>(m, feats, w, bias, mask, hist, n, per_img, C, grid, stream);
    case 24: return launch_np<F, 24, HIST>(m, feats, w, bias, mask, hist, n, per_img, C, grid, stream);
    case 32: return launch_np<F, 32, HIST>(m, feats, w, bias, mask, hist, n, per_img, C, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int F>
cudaError_t launch_f(const bf16* feats, const float* w, const float* bias, uint8_t* mask,
                     int* hist, int n, int per_img, int C, bool with_hist, cudaStream_t stream) {
  constexpr int TILE = Geo<F>::TILE;
  if (with_hist && (per_img < 1 || per_img % TILE || n % per_img)) return cudaErrorInvalidValue;
  const int tiles = (n + TILE - 1) / TILE;
  const int grid = tiles < Geo<F>::CTAS ? tiles : Geo<F>::CTAS;
  const int np = (C + 7) / 8 * 8;
  CUtensorMap m = {};
  if constexpr (F == 64) {
    const cudaError_t e = feature_map(&m, feats, n);
    if (e != cudaSuccess) return e;
  }
  return with_hist
             ? launch<F, true>(m, feats, w, bias, mask, hist, n, per_img, C, np, grid, stream)
             : launch<F, false>(m, feats, w, bias, mask, nullptr, n, 1, C, np, grid, stream);
}

}  // namespace

namespace tu {

// feats (n, F) bf16, w (F, C) and bias (C) float32, mask (n) uint8, hist
// (n / per_img, C) int32 zeroed (with_hist; per_img a multiple of the
// tile) or null.  The plan (kernels/postprocess.py::tail_plan): NP = C
// rounded up to 8, grid = the tiles, at most CTAS.
int launch_final_tail(const bf16* feats, const float* w, const float* bias, uint8_t* mask,
                      int* hist, int n, int per_img, int F, int C, bool with_hist,
                      cudaStream_t stream) {
  if (n < 1 || C < 1 || C > MAXC || (reinterpret_cast<uintptr_t>(feats) & 15) ||
      (reinterpret_cast<uintptr_t>(mask) & 15))
    return cudaErrorInvalidValue;
  switch (F) {
    case 22: return launch_f<22>(feats, w, bias, mask, hist, n, per_img, C, with_hist, stream);
    case 32: return launch_f<32>(feats, w, bias, mask, hist, n, per_img, C, with_hist, stream);
    case 64: return launch_f<64>(feats, w, bias, mask, hist, n, per_img, C, with_hist, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tu
