// GroupNorm(G, eps) + optional SiLU backward over NHWC rows, for Hopper (sm_90a).
//
// Replaces generative_detection_tpu/ops/norm.py `_make_gn_chunked_custom_vjp`'s
// backward: the reduce kernel `_gn_bwd_reduce_chunk_kernel` (B4c) and the dx
// kernel `_gn_bwd_dx_chunk_kernel` (B4d). On the TPU both kernels walk the
// (b, chunk) grid in order and accumulate per-channel sums in a resident VMEM
// block. Hopper's blocks run in no order, so each block writes the partial
// sums of its own row tile and the next launch folds them in a fixed order:
// no atomics, and results repeat bit for bit from run to run.
//
// With xhat = (x - mean) * rstd, z = xhat * gamma + beta and
// dz = dy * sig(z) * (1 + z * (1 - sig(z))) under SiLU (dz = dy without it):
//
//   dgamma_c = sum dz * xhat,  dbeta_c = sum dz       (over b and rows)
//   m1_bg = mean_{rows, c in g} dz * gamma,  m2_bg = mean dz * gamma * xhat
//   dx = (dz * gamma - m1 - xhat * m2) * rstd
//
// Launches:
//   (i)  gn_bwd_reduce (B4c): block (tile, b) folds the forward's stats
//        partials (the buffer `gdt_group_norm_fwd` wrote) into mean and rstd,
//        reads its rows of x and dy once, and writes per-channel
//        (sum dz*xhat, sum dz) to chan[b][tile][2][C] and their gamma-weighted
//        group sums (the m2 and m1 numerators) to grp[b][tile][2][G].
//   (ii) gn_bwd_dx (B4d): block (tile, b) folds the forward stats and grp of
//        image b, reads x and dy again and writes dx in the input dtype. The
//        first 2C / 32 blocks also fold chan over (b, tile) into dgamma and
//        dbeta, 32 columns a block and 8 warps down the rows, not one
//        block's threads down all of them.
//
// Bound on the H100: memory. The function must read x and dy once and write
// dx once; the kernels read x and dy twice (the second read from L2 only
// where the pair fits it) and write dx once, with 16-byte vector accesses by
// consecutive threads on consecutive channels (bf16: four rows of x and dy
// a thread in flight). The SiLU's derivative takes the fast exp and
// reciprocal (one MUFU operation each). Statistics and all sums are fp32.
// One launch that reads x and dy from HBM once lost to these two, in two
// designs (PERF.md records the ablations).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// N: values in 16 bytes. U: rows of 16-byte loads of x and of dy a thread of
// the two launches has in flight (bf16: four; fp32, whose four values a load
// carry half the arithmetic, is bound by HBM at one, and more lose)
template <typename T> struct VecTraits;
template <> struct VecTraits<float> { static constexpr int N = 4, U = 1; };
template <> struct VecTraits<__nv_bfloat16> { static constexpr int N = 8, U = 4; };

// 16 bytes of a row (N values): loaded raw, unpacked to fp32 where they are used
__device__ __forceinline__ uint4 load_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void unpack(uint4 u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* out, __nv_bfloat16) {
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

// The forward's per-group mean and rstd of image b, folded from its stats
// partials exactly as gn_apply_kernel in group_norm.cu folds them.
__device__ __forceinline__ void fold_fwd_stats(const float* __restrict__ partial, int b,
                                               int L, int C, int G, int tiles, float eps,
                                               float* s_mean, float* s_rstd) {
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
}

template <bool SILU>
__device__ __forceinline__ float grad_z(float xhat, float dy, float ga, float be) {
  if (!SILU) return dy;
  const float z = xhat * ga + be;
  const float sig = __frcp_rn(1.f + __expf(-z));
  return dy * sig * (1.f + z * (1.f - sig));
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ partial, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ chan,
                     float* __restrict__ grp, int L, int C, int G, int rows_per_tile,
                     int tiles, float eps) {
  constexpr int N = VecTraits<T>::N, U = VecTraits<T>::U;
  const int lanes = C / N, rpi = kThreads / lanes;
  extern __shared__ float smem[];
  float* s_mean = smem;                   // [G]
  float* s_rstd = s_mean + G;             // [G]
  float* s_red = s_rstd + G;              // [2][rpi][C]: dz*xhat, dz
  float* s_chan = s_red + 2 * rpi * C;    // [2][C]
  const int tile = blockIdx.x, b = blockIdx.y;
  fold_fwd_stats(partial, b, L, C, G, tiles, eps, s_mean, s_rstd);
  __syncthreads();

  const int lane = threadIdx.x % lanes, ri = threadIdx.x / lanes;
  const int cg = C / G;
  if (ri < rpi) {
    float m[N], r[N], ga[N], be[N], sdx[N], sd[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = lane * N + j;
      m[j] = s_mean[c / cg];
      r[j] = s_rstd[c / cg];
      ga[j] = gamma[c];
      be[j] = beta[c];
      sdx[j] = 0.f;
      sd[j] = 0.f;
    }
    const int row0 = tile * rows_per_tile;
    const int row1 = min(row0 + rows_per_tile, L);
    const size_t off = (size_t)b * L * C + lane * N;
    for (int row = row0 + ri; row < row1; row += U * rpi) {
      uint4 xr[U], gr[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (row + u * rpi < row1) {
          xr[u] = load_raw(x + off + (size_t)(row + u * rpi) * C);
          gr[u] = load_raw(dy + off + (size_t)(row + u * rpi) * C);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (row + u * rpi < row1) {
          float xv[N], gv[N];
          unpack(xr[u], xv, T());
          unpack(gr[u], gv, T());
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float xhat = (xv[j] - m[j]) * r[j];
            const float dz = grad_z<SILU>(xhat, gv[j], ga[j], be[j]);
            sdx[j] += dz * xhat;
            sd[j] += dz;
          }
        }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s_red[ri * C + lane * N + j] = sdx[j];
      s_red[rpi * C + ri * C + lane * N + j] = sd[j];
    }
  }
  __syncthreads();

  // Fold row slots into per-channel sums, in a fixed order.
  float* chan_out = chan + ((size_t)b * tiles + tile) * 2 * C;
  for (int k = threadIdx.x; k < 2 * C; k += kThreads) {
    const int which = k / C, c = k % C;
    const float* src = s_red + which * rpi * C + c;
    float acc = 0.f;
    for (int rr = 0; rr < rpi; ++rr) acc += src[rr * C];
    s_chan[k] = acc;
    chan_out[k] = acc;
  }
  __syncthreads();
  // gamma-weighted group sums: grp[..][0] -> m2 numerator, [1] -> m1 numerator
  float* grp_out = grp + ((size_t)b * tiles + tile) * 2 * G;
  for (int k = threadIdx.x; k < 2 * G; k += kThreads) {
    const int which = k / G, g = k % G;
    float acc = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) acc += gamma[c] * s_chan[which * C + c];
    grp_out[k] = acc;
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ partial, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ chan,
                 const float* __restrict__ grp, T* __restrict__ dx,
                 float* __restrict__ dgb, int B, int L, int C, int G, int rows_per_tile,
                 int tiles, float eps) {
  constexpr int N = VecTraits<T>::N, U = VecTraits<T>::U;
  extern __shared__ float smem[];  // [4][G]: mean, rstd, m1, m2
  float* s_mean = smem;
  float* s_rstd = smem + G;
  float* s_m1 = smem + 2 * G;
  float* s_m2 = smem + 3 * G;
  const int tile = blockIdx.x, b = blockIdx.y;
  fold_fwd_stats(partial, b, L, C, G, tiles, eps, s_mean, s_rstd);
  const float denom = (float)L * (float)(C / G);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s2 = 0.f, s1 = 0.f;
    const float* p = grp + (size_t)b * tiles * 2 * G + g;
    for (int t = 0; t < tiles; ++t) {
      s2 += p[(2 * t) * G];
      s1 += p[(2 * t + 1) * G];
    }
    s_m1[g] = s1 / denom;
    s_m2[g] = s2 / denom;
  }

  // dgamma, dbeta: block j folds chan's columns 32 j .. 32 j + 31 (and j +
  // the grid's blocks, ...) over (b, tile): warp w the rows w, w + 8, ... in
  // order, then the eight warps' sums in warp order.
  __shared__ float s_fold[kThreads / 32][32];
  const int nblocks = gridDim.x * gridDim.y, w = threadIdx.x / 32, wl = threadIdx.x % 32;
  for (int cb = blockIdx.y * gridDim.x + blockIdx.x; cb * 32 < 2 * C; cb += nblocks) {
    const int k = cb * 32 + wl;
    float acc = 0.f;
    if (k < 2 * C) {
#pragma unroll 4
      for (int bt = w; bt < B * tiles; bt += kThreads / 32) acc += chan[(size_t)bt * 2 * C + k];
    }
    s_fold[w][wl] = acc;
    __syncthreads();
    if (w == 0 && k < 2 * C) {
      float sum = 0.f;
      for (int i = 0; i < kThreads / 32; ++i) sum += s_fold[i][wl];
      dgb[k] = sum;
    }
    __syncthreads();
  }
  __syncthreads();  // the stats above, for blocks that folded no columns

  const int lanes = C / N, rpi = kThreads / lanes;
  const int lane = threadIdx.x % lanes, ri = threadIdx.x / lanes;
  if (ri >= rpi) return;
  const int cg = C / G;
  float m[N], r[N], ga[N], be[N], m1[N], m2[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = lane * N + j;
    m[j] = s_mean[c / cg];
    r[j] = s_rstd[c / cg];
    m1[j] = s_m1[c / cg];
    m2[j] = s_m2[c / cg];
    ga[j] = gamma[c];
    be[j] = beta[c];
  }
  const int row0 = tile * rows_per_tile;
  const int row1 = min(row0 + rows_per_tile, L);
  const size_t off = (size_t)b * L * C + lane * N;
  for (int row = row0 + ri; row < row1; row += U * rpi) {
    uint4 xr[U], gr[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row + u * rpi < row1) {
        xr[u] = load_raw(x + off + (size_t)(row + u * rpi) * C);
        gr[u] = load_raw(dy + off + (size_t)(row + u * rpi) * C);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row + u * rpi < row1) {
        float xv[N], gv[N];
        unpack(xr[u], xv, T());
        unpack(gr[u], gv, T());
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xhat = (xv[j] - m[j]) * r[j];
          const float dz = grad_z<SILU>(xhat, gv[j], ga[j], be[j]);
          xv[j] = (dz * ga[j] - m1[j] - xhat * m2[j]) * r[j];
        }
        store_vec(dx + off + (size_t)(row + u * rpi) * C, xv);
      }
  }
}

template <typename T, bool SILU>
int launch(const void* x, const void* dy, const void* partial, const void* gamma,
           const void* beta, void* chan, void* grp, void* dx, void* dgb, int B, int L,
           int C, int G, int rows_per_tile, int tiles, float eps, cudaStream_t stream) {
  constexpr int N = VecTraits<T>::N;
  const int rpi = kThreads / (C / N);
  dim3 grid(tiles, B);
  const size_t reduce_smem = (2 * G + 2 * rpi * C + 2 * C) * sizeof(float);
  gn_bwd_reduce_kernel<T, SILU><<<grid, kThreads, reduce_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(partial), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(chan), static_cast<float*>(grp),
      L, C, G, rows_per_tile, tiles, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_dx_kernel<T, SILU><<<grid, kThreads, 4 * G * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(partial), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(chan),
      static_cast<const float*>(grp), static_cast<T*>(dx), static_cast<float*>(dgb), B, L,
      C, G, rows_per_tile, tiles, eps);
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" {

// x, dy, dx: (B, L, C) contiguous, fp32 (dtype 0) or bf16 (dtype 1);
// partial: the (B, tiles, 2, G) fp32 stats buffer of the forward launch on
// the same x with the same rows_per_tile; gamma, beta: (C,) fp32;
// chan: (B, tiles, 2, C) and grp: (B, tiles, 2, G) fp32 scratch; dgb: (2, C)
// fp32 output (dgamma, dbeta). Shapes are checked by the Python wrapper.
// Returns cudaGetLastError().
int gdt_group_norm_bwd(const void* x, const void* dy, const void* partial, const void* gamma,
                       const void* beta, void* chan, void* grp, void* dx, void* dgb, int B,
                       int L, int C, int G, int rows_per_tile, int tiles, float eps, int silu,
                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GDT_GN_BWD(T, S)                                                                  \
  return launch<T, S>(x, dy, partial, gamma, beta, chan, grp, dx, dgb, B, L, C, G,        \
                      rows_per_tile, tiles, eps, s)
  if (dtype == 0) {
    if (silu) GDT_GN_BWD(float, true);
    GDT_GN_BWD(float, false);
  }
  if (dtype == 1) {
    if (silu) GDT_GN_BWD(__nv_bfloat16, true);
    GDT_GN_BWD(__nv_bfloat16, false);
  }
#undef GDT_GN_BWD
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
