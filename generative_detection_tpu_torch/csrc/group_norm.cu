// GroupNorm(G, eps) + optional SiLU over NHWC rows, for Hopper (sm_90a).
//
// Replaces generative_detection_tpu/ops/norm.py `_gn_pallas` (kernel
// `_gn_kernel`): the TPU kernel holds one image's whole (H*W, C) row in VMEM
// and does stats + normalize in one HBM round trip, which is why it only
// takes rows of <= 512K elements. A Hopper block has at most 227 KB of
// shared memory, so no row of this model (up to 256*256*128 elements) stays
// resident. The work is split in two launches instead:
//
//   (i)  gn_stats:  block (tile, b) sums per-channel x and x*x in fp32 over
//        `rows_per_tile` rows, folds channels into groups, and writes the
//        (sum, sumsq) partials of its tile to partial[b][tile][2][G]. Each
//        partial is written by exactly one block in a fixed order: no
//        atomics, so results repeat bit for bit from run to run.
//   (ii) gn_apply:  block (tile, b) folds the partials of image b into
//        per-group mean and rstd, then writes silu((x-mean)*rstd*gamma+beta)
//        in the input dtype.
//
// Bound on the H100: memory. The function must read x once and write y once
// (2 bytes per element each in bf16); the kernel reads x twice (the second
// read partly from L2) and writes y once, with 16-byte vector accesses by
// consecutive threads on consecutive channels.
//
// The variance is clamped at >= 0 (as `_gn_reference` does, norm.py:54); the
// TPU kernel does not clamp (norm.py:90). The one-pass E[x^2] - E[x]^2 can
// go slightly negative for a constant group, and rsqrt of a negative number
// would give NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct VecTraits;
template <> struct VecTraits<float> { static constexpr int N = 4; };
template <> struct VecTraits<__nv_bfloat16> { static constexpr int N = 8; };

// 16-byte vector load of N elements, widened to fp32.
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Thread layout shared by both passes: `lanes` = C / N threads cover one row
// with N channels each; the block walks `rpi` = kThreads / lanes rows at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int L, int C,
                int G, int rows_per_tile, int tiles) {
  constexpr int N = VecTraits<T>::N;
  extern __shared__ float smem[];  // [2][rpi][C]
  const int tile = blockIdx.x, b = blockIdx.y;
  const int lanes = C / N, rpi = kThreads / lanes;
  const int lane = threadIdx.x % lanes, ri = threadIdx.x / lanes;
  const int row0 = tile * rows_per_tile;
  const int row1 = min(row0 + rows_per_tile, L);

  float s[N], ss[N];
#pragma unroll
  for (int j = 0; j < N; ++j) { s[j] = 0.f; ss[j] = 0.f; }
  if (ri < rpi) {
    const T* base = x + (size_t)b * L * C + lane * N;
    for (int r = row0 + ri; r < row1; r += rpi) {
      float v[N];
      load_vec(base + (size_t)r * C, v);
#pragma unroll
      for (int j = 0; j < N; ++j) { s[j] += v[j]; ss[j] += v[j] * v[j]; }
    }
    float* s_sum = smem + ri * C + lane * N;
    float* s_sq = smem + rpi * C + ri * C + lane * N;
#pragma unroll
    for (int j = 0; j < N; ++j) { s_sum[j] = s[j]; s_sq[j] = ss[j]; }
  }
  __syncthreads();

  // Fold (row slot, channel) partials into groups, in a fixed order.
  const int cg = C / G;
  for (int k = threadIdx.x; k < 2 * G; k += kThreads) {
    const int which = k / G, g = k % G;
    const float* src = smem + which * rpi * C + g * cg;
    float acc = 0.f;
    for (int r = 0; r < rpi; ++r)
      for (int c = 0; c < cg; ++c) acc += src[r * C + c];
    partial[(((size_t)b * tiles + tile) * 2 + which) * G + g] = acc;
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                T* __restrict__ y, int L, int C, int G, int rows_per_tile, int tiles,
                float eps) {
  constexpr int N = VecTraits<T>::N;
  extern __shared__ float smem[];  // [2][G]: mean, rstd
  const int tile = blockIdx.x, b = blockIdx.y;
  float* s_mean = smem;
  float* s_rstd = smem + G;
  const float denom = (float)L * (float)(C / G);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.f, ss = 0.f;
    const float* p = partial + (size_t)b * tiles * 2 * G + g;
    for (int t = 0; t < tiles; ++t) {
      s += p[(2 * t) * G];
      ss += p[(2 * t + 1) * G];
    }
    const float mean = s / denom;
    const float var = fmaxf(ss / denom - mean * mean, 0.f);
    s_mean[g] = mean;
    s_rstd[g] = rsqrtf(var + eps);
  }
  __syncthreads();

  const int lanes = C / N, rpi = kThreads / lanes;
  const int lane = threadIdx.x % lanes, ri = threadIdx.x / lanes;
  if (ri >= rpi) return;
  const int cg = C / G;
  float m[N], r[N], ga[N], be[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = lane * N + j;
    m[j] = s_mean[c / cg];
    r[j] = s_rstd[c / cg];
    ga[j] = gamma[c];
    be[j] = beta[c];
  }
  const int row0 = tile * rows_per_tile;
  const int row1 = min(row0 + rows_per_tile, L);
  const size_t off = (size_t)b * L * C + lane * N;
  for (int row = row0 + ri; row < row1; row += rpi) {
    float v[N];
    load_vec(x + off + (size_t)row * C, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float t = (v[j] - m[j]) * r[j];
      t = t * ga[j] + be[j];
      if (SILU) t = t / (1.f + expf(-t));
      v[j] = t;
    }
    store_vec(y + off + (size_t)row * C, v);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, void* partial,
           int B, int L, int C, int G, int rows_per_tile, int tiles, float eps, int silu,
           cudaStream_t stream) {
  constexpr int N = VecTraits<T>::N;
  const int rpi = kThreads / (C / N);
  dim3 grid(tiles, B);
  gn_stats_kernel<T><<<grid, kThreads, 2 * rpi * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), L, C, G, rows_per_tile, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t apply_smem = 2 * G * sizeof(float);
  if (silu) {
    gn_apply_kernel<T, true><<<grid, kThreads, apply_smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(partial),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<T*>(y), L, C, G, rows_per_tile, tiles, eps);
  } else {
    gn_apply_kernel<T, false><<<grid, kThreads, apply_smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(partial),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<T*>(y), L, C, G, rows_per_tile, tiles, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (B, L, C) contiguous, fp32 (dtype 0) or bf16 (dtype 1); gamma, beta:
// (C,) fp32; partial: (B, tiles, 2, G) fp32 scratch. Shapes are checked by the
// Python wrapper: C % G == 0, C / (16 / sizeof(elem)) <= 256, 16-byte aligned
// pointers, tiles == ceil(L / rows_per_tile). Returns cudaGetLastError().
int gdt_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                       void* partial, int B, int L, int C, int G, int rows_per_tile,
                       int tiles, float eps, int silu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, beta, y, partial, B, L, C, G, rows_per_tile, tiles,
                         eps, silu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, y, partial, B, L, C, G, rows_per_tile,
                                 tiles, eps, silu, s);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
