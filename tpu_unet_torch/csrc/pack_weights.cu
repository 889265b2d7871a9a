// pack_weights: the Hopper conv core's weight operand from OIHW conv
// weights (F, C, 3, 3), in one read and one write:
//   forward:  out[f, (ky * 3 + kx) * C + c] = w[f, c, ky, kx]            (F rows)
//   dgrad:    out[c, (ky * 3 + kx) * F + f] = w[f, c, 2 - ky, 2 - kx]    (C rows)
// the dgrad's being the forward layout of flipT(w) (the taps reversed, the
// channels swapped); rows of kp >= 9 C (forward) or 9 F (dgrad) columns,
// the columns past the taps zero (the stem's conv1_1, C = 3, pads to one
// 128-byte box).  Values: bf16 rounded to nearest even, as .to(bfloat16);
// float32 rounded to TF32 by the integer rule of kernels/_build.py::
// round_tf32, (bits + 0x1000) & ~0x1FFF, so the packed weights are
// bit-identical to the plain version's.  The input has the output's type.
//
// Replaces no Pallas kernel: the TPU kernels take their weights from XLA,
// which flips and transposes them outside the kernel
// (tpu_unet/kernels/decoder_train.py:55-57, _flip_t, ahead of the
// pallas_call at :140).  Here the wrappers repacked them eagerly on every
// call: a flip copy, a permute copy and, in float32, two elementwise
// passes of the rounding (four kernels and four round trips a weight).
// One launch packs every weight of a wrapper's call (at most three).
//
// A block takes a tile of 32 f x 32 c x 9 taps: it reads the tile's f rows,
// each 9 x 32 contiguous values of w, a thread's 36 loads all in flight,
// into shared memory (a row of 289 floats: the odd stride keeps both write
// walks free of bank conflicts), then writes the tile's output runs, 32
// contiguous values of a row and tap: 32 channels (forward) or 32 output
// channels (dgrad), 16 bytes a thread where every run starts aligned, else
// one value.  Reads and writes are coalesced; the ragged edge (C or F no
// multiple of 32) is masked.  Blocks are numbered over the weights in turn,
// the c tiles of one f tile adjacent.  The host's mirror of the walk is
// kernels/sm90.py::pack_tiles / pack_vector; tests/test_torch_pack.py
// emulates it.  (A first build that kept one load in flight and stored one
// value a thread ran markedly slower on an H100, in bf16 slower than the
// eager copy; the loads in flight and the 16-byte stores are what took it
// to its bound's neighbourhood: PERF.md, Findings.)
//
// Bound on the H100: bytes, each weight read once and its operand written
// once: 2 x 56.6 MB for unet_resnet50's up4 w1 (3072 -> 512) in float32,
// 0.034 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;           // f and c of a tile
constexpr int TROW = 9 * TILE;     // a tile's values of one f row (9 taps x 32 c)
constexpr int SROW = TROW + 1;     // the staged row: the odd stride
constexpr int THREADS = 256;
constexpr int PER = TILE * TROW / THREADS;  // values a thread moves: 36
constexpr int MAX_WEIGHTS = 3;
constexpr int DESC_WORDS = 5;      // src, dst, F, C, kp

struct PackArgs {
  const void* src[MAX_WEIGHTS];
  void* dst[MAX_WEIGHTS];
  int F[MAX_WEIGHTS], C[MAX_WEIGHTS], kp[MAX_WEIGHTS];
  int end[MAX_WEIGHTS];  // the tiles of weights 0..i
  int n;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// float32 to TF32, to nearest with ties away from zero, by round_tf32's
// integer rule (its 13 low bits zero)
__device__ __forceinline__ float tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & ~0x1FFFu);
}

// V consecutive outputs from float32: V = 1, or 16 bytes (4 float32 or 8
// bf16) at a 16-byte-aligned p
template <int V>
__device__ __forceinline__ void put(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = tf32(v[0]);
  } else {
    static_assert(V == 4, "16 bytes");
    *reinterpret_cast<float4*>(p) = make_float4(tf32(v[0]), tf32(v[1]), tf32(v[2]), tf32(v[3]));
  }
}
template <int V>
__device__ __forceinline__ void put(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    static_assert(V == 8, "16 bytes");
    __align__(16) __nv_bfloat162 h[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  }
}

// VEC: every run and row of the launch's outputs starts 16-byte aligned
// (kernels/sm90.py::pack_vector), so a thread writes V = 16 bytes at once
template <typename T, bool FLIP, bool VEC>
__global__ void __launch_bounds__(THREADS, 4) pack_kernel(const __grid_constant__ PackArgs a) {
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int RUN = TILE / V;  // threads of a 32-value run
  __shared__ float s[TILE * SROW];
  int i = 0;
  while (i + 1 < a.n && static_cast<int>(blockIdx.x) >= a.end[i]) ++i;
  const int t = blockIdx.x - (i ? a.end[i - 1] : 0);
  const int F = a.F[i], C = a.C[i], kp = a.kp[i];
  const int tc = (C + TILE - 1) / TILE;
  const int f0 = (t / tc) * TILE, c0 = (t - (t / tc) * tc) * TILE;
  const int nf = min(TILE, F - f0), nc = min(TILE, C - c0);
  const T* w = static_cast<const T*>(a.src[i]);
  T* out = static_cast<T*>(a.dst[i]);

  // the tile's f rows: 9 nc contiguous values each, from (f, c0, 0, 0);
  // a thread's PER loads all in flight before the first lands in s
  float v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / TROW, k = e - r * TROW;
    v[u] = r < nf && k < 9 * nc ? load_f(w + (static_cast<size_t>(f0 + r) * C + c0) * 9 + k)
                                : 0.f;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * THREADS;
    s[e + e / TROW] = v[u];  // row e / TROW at the SROW stride
  }
  __syncthreads();
  // the output runs, 32 contiguous values of a row and tap, RUN threads
  // each (a warp's lanes on consecutive values), V values a thread; with
  // VEC a ragged run's length is a multiple of V
#pragma unroll 4
  for (int e = threadIdx.x; e < TILE * 9 * RUN; e += THREADS) {
    const int r = e / (9 * RUN), rem = e - r * 9 * RUN, tap = rem / RUN;
    const int j = (rem - tap * RUN) * V;
    float o[V];
    if (!FLIP) {  // row f0 + r, tap, channels c0 + j ..
      if (r >= nf || j >= nc) continue;
#pragma unroll
      for (int q = 0; q < V; ++q) o[q] = s[r * SROW + (j + q) * 9 + tap];
      put<V>(out + static_cast<size_t>(f0 + r) * kp + tap * C + c0 + j, o);
    } else {  // row c0 + r, tap, output channels f0 + j ..: w[f0 + j, c0 + r, 8 - tap]
      if (r >= nc || j >= nf) continue;
#pragma unroll
      for (int q = 0; q < V; ++q) o[q] = s[(j + q) * SROW + r * 9 + 8 - tap];
      put<V>(out + static_cast<size_t>(c0 + r) * kp + tap * F + f0 + j, o);
    }
  }
  // the zero columns past the taps, by the rows' first tile of the other axis
  const int rows = FLIP ? nc : nf, cols = 9 * (FLIP ? F : C);
  if ((FLIP ? f0 : c0) == 0 && kp > cols) {
    const int row0 = FLIP ? c0 : f0, pad = kp - cols;
    const float zero[1] = {0.f};
    for (int e = threadIdx.x; e < rows * pad; e += THREADS) {
      const int r = e / pad;
      put<1>(out + static_cast<size_t>(row0 + r) * kp + cols + (e - r * pad), zero);
    }
  }
}

template <typename T>
int launch(const PackArgs& a, int flip, bool vec, cudaStream_t stream) {
  const int blocks = a.end[a.n - 1];
  if (flip && vec)
    pack_kernel<T, true, true><<<blocks, THREADS, 0, stream>>>(a);
  else if (flip)
    pack_kernel<T, true, false><<<blocks, THREADS, 0, stream>>>(a);
  else if (vec)
    pack_kernel<T, false, true><<<blocks, THREADS, 0, stream>>>(a);
  else
    pack_kernel<T, false, false><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// desc: n (1-3) rows of DESC_WORDS int64 on the host: the weight's and the
// output's device addresses, F, C and kp (the output row's columns: at
// least 9 C, or 9 F with flip); weights and outputs bf16 (f32 0) or
// float32, the outputs then rounded to TF32.
extern "C" int tu_pack_weights(const int64_t* desc, int n, int f32, int flip,
                               cudaStream_t stream) {
  if (n < 1 || n > MAX_WEIGHTS) return cudaErrorInvalidValue;
  PackArgs a{};
  a.n = n;
  int tiles = 0;
  const int64_t vw = f32 ? 4 : 8;  // outputs in 16 bytes
  bool vec = true;
  for (int i = 0; i < n; ++i) {
    const int64_t* d = desc + DESC_WORDS * i;
    const int64_t F = d[2], C = d[3], kp = d[4];
    if (!d[0] || !d[1] || F < 1 || C < 1 || kp < 9 * (flip ? F : C) ||
        (flip ? C : F) * kp >= (int64_t{1} << 31))
      return cudaErrorInvalidValue;
    vec = vec && kp % vw == 0 && (flip ? F : C) % vw == 0 && d[1] % 16 == 0;
    a.src[i] = reinterpret_cast<const void*>(d[0]);
    a.dst[i] = reinterpret_cast<void*>(d[1]);
    a.F[i] = static_cast<int>(F);
    a.C[i] = static_cast<int>(C);
    a.kp[i] = static_cast<int>(kp);
    tiles += static_cast<int>(((F + TILE - 1) / TILE) * ((C + TILE - 1) / TILE));
    a.end[i] = tiles;
  }
  return f32 ? launch<float>(a, flip, vec, stream) : launch<__nv_bfloat16>(a, flip, vec, stream);
}
