// Row-Winograd weight gradient of a 3x3 stride-1 SAME convolution over NHWC,
// for Hopper (sm_90a):
//
//   dU[a, dx] = sum_{b, t, x} V_a(z)[b, t, x + dx - 1]^T dM_a(dy)[b, t, x]
//   V_a[t]    = sum_u BT[a, u] z[M t + u - 1]        (fp32 sum, cast to T)
//   dM_a[t]   = sum_i AT[i, a] dy[M t + i]           (in T, as the TPU kernel)
//
// over all images, t-rows and columns, into (P*3, C, CO) fp32 with P = M + 2
// (M = 2: F(2,3); M = 4: F(4,3)). The caller folds dK[ky] = sum_a G[a, ky]
// dU[a] (a torch op). With `gn`, z is the raw pre-norm input and the
// activation silu(z a + b) is recomputed from it here (rows and columns
// outside the image are zero after the activation).
//
// Replaces generative_detection_tpu/ops/winograd_pallas.py
// `_wino_wgrad_pallas` (kernel `_wino_wgrad_kernel`). The TPU kernel carries
// dU in one VMEM block across its sequential grid. Blocks on the H100 run in
// no order, so the reduction over positions is split: block (c tile, co tile,
// point a, split s) sums its fixed share of the position chunks into a
// partial in device memory, and a second launch folds the partials in split
// order. No atomics: the result repeats bit for bit.
//
// Each block keeps 64 input x 64 output channels and three accumulators (one
// per dx). Per chunk of KP = 32 columns of one t-row it stages V_a for the
// KP + 2 columns (the column shift is an offset into shared memory) and dM_a,
// then multiplies: bf16 on the tensor cores (mma.sync m16n8k16, fp32
// accumulate, both operands by ldmatrix.trans), fp32 with FMA.
//
// Bound on the H100: compute, on the direct-conv yardstick (2 * 9 * B * H *
// W * C * CO flops; the Winograd form does P * 3 / (9 * M) of them).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int TC = 64;   // input channels per block
constexpr int TN = 64;   // output channels per block
constexpr int KP = 32;   // columns per chunk

__constant__ float kBT2[4][4] = {{1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
__constant__ float kAT2[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
__constant__ float kBT4[6][6] = {
    {4, 0, -5, 0, 1, 0}, {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},
    {0, -2, -1, 2, 1, 0}, {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}};
__constant__ float kAT4[4][6] = {
    {1, 1, 1, 1, 1, 0}, {0, 1, -1, 2, -2, 0}, {0, 1, 1, 4, 4, 0}, {0, 1, -1, 8, -8, 1}};

template <int M>
__device__ __forceinline__ float bt(int a, int u) {
  return M == 2 ? kBT2[a][u] : kBT4[a][u];
}
template <int M>
__device__ __forceinline__ float at(int i, int a) {
  return M == 2 ? kAT2[i][a] : kAT4[i][a];
}

template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> { static constexpr int VEC = 8, PITCH = 72; };
template <> struct Ty<float> { static constexpr int VEC = 4, PITCH = 68; };

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
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

struct Geom {
  int B, H, W, C, CO;
  int HT;        // t-rows per image: H / M
  int n_xc;      // column chunks per t-row: ceil(W / KP)
  int n_chunks;  // B * HT * n_xc
  int splits;
};

// Stage one chunk (image b, t-row t, columns x0 .. x0 + KP - 1) for point a:
// Vs[slot][c] = V_a at column x0 + slot - 1 (slots 0 .. KP + 1) and
// Ds[p][co] = dM_a at column x0 + p, zero outside the image.
template <typename T, int M, bool GN>
__device__ __forceinline__ void stage_chunk(T* Vs, T* Ds, const T* __restrict__ z,
                                            const T* __restrict__ dy,
                                            const float* __restrict__ ga,
                                            const float* __restrict__ gb, const Geom& g,
                                            int a, int b, int t, int x0, int c0, int co0) {
  constexpr int P = M + 2, VEC = Ty<T>::VEC, PITCH = Ty<T>::PITCH;
  constexpr int NV = TC / VEC;
  for (int it = threadIdx.x; it < (KP + 2) * NV; it += kThreads) {
    const int s = it / NV, cv = (it % NV) * VEC;
    const int xx = x0 + s - 1;
    const int c = c0 + cv;
    float gav[VEC], gbv[VEC];
    if (GN) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        gav[j] = ga[(size_t)b * g.C + c + j];
        gbv[j] = gb[(size_t)b * g.C + c + j];
      }
    }
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = 0.f;
    if (xx >= 0 && xx < g.W) {
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int y = M * t + u - 1;
        if (y < 0 || y >= g.H) continue;  // zero row: adds nothing
        float r[VEC];
        load_vec(z + (((size_t)b * g.H + y) * g.W + xx) * g.C + c, r);
        const float cf = bt<M>(a, u);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float zv = r[j];
          if (GN) {
            const float w = zv * gav[j] + gbv[j];
            zv = round_to(w / (1.f + expf(-w)), z);
          }
          v[j] = fmaf(cf, zv, v[j]);
        }
      }
    }
    store_vec(Vs + s * PITCH + cv, v);  // rounds to T
  }
  constexpr int NN = TN / VEC;
  for (int it = threadIdx.x; it < KP * NN; it += kThreads) {
    const int p = it / NN, nv = (it % NN) * VEC;
    const int xx = x0 + p;
    float d[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    if (xx < g.W) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float r[VEC];
        load_vec(dy + (((size_t)b * g.H + M * t + i) * g.W + xx) * g.CO + co0 + nv, r);
        const float cf = at<M>(i, a);
        // in T, one rounding per add: the TPU kernel sums the dy phases in
        // dy's dtype (the products by powers of two are exact)
#pragma unroll
        for (int j = 0; j < VEC; ++j) d[j] = round_to(d[j] + cf * r[j], z);
      }
    }
    store_vec(Ds + p * PITCH + nv, d);
  }
}

__device__ __forceinline__ void chunk_coords(const Geom& g, int k, int* b, int* t, int* x0) {
  const int xc = k % g.n_xc;
  const int row = k / g.n_xc;  // image * HT + t
  *t = row % g.HT;
  *b = row / g.HT;
  *x0 = xc * KP;
}

// grid: (C/TC * CO/TN, P, splits); part: (splits, P*3, C, CO) fp32
template <int M, bool GN>
__global__ void __launch_bounds__(kThreads)
wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ dy,
                  const float* __restrict__ ga, const float* __restrict__ gb,
                  float* __restrict__ part, Geom g) {
  using T = __nv_bfloat16;
  constexpr int P = M + 2, PITCH = Ty<T>::PITCH;
  __shared__ __align__(16) T Vs[(KP + 2) * PITCH];
  __shared__ __align__(16) T Ds[KP * PITCH];
  const int n_tiles = g.CO / TN;
  const int c0 = (blockIdx.x / n_tiles) * TC, co0 = (blockIdx.x % n_tiles) * TN;
  const int a = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;  // 16 input channels, 32 output channels
  const int gq = lane >> 2, tq = lane & 3;
  // ldmatrix.trans lane roles: A = Vs^T (rows c, k = columns), B = Ds (k, n)
  const int a_p = (lane & 7) + (lane >> 4) * 8, a_c = ((lane >> 3) & 1) * 8;
  const int b_p = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;

  float acc[3][4][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dx][j][e] = 0.f;

  const int k0 = (int)((long long)s * g.n_chunks / g.splits);
  const int k1 = (int)((long long)(s + 1) * g.n_chunks / g.splits);
  for (int k = k0; k < k1; ++k) {
    int b, t, x0;
    chunk_coords(g, k, &b, &t, &x0);
    __syncthreads();
    stage_chunk<T, M, GN>(Vs, Ds, z, dy, ga, gb, g, a, b, t, x0, c0, co0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KP; kk += 16) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, Vs + (kk + a_p + dx) * PITCH + wm * 16 + a_c);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, Ds + (kk + b_p) * PITCH + wn * 32 + b_n + j * 8);
          mma_bf16(acc[dx][j], af, bf[0], bf[1]);
          mma_bf16(acc[dx][j + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* dst = part + (((size_t)s * P + a) * 3 + dx) * g.C * g.CO;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + wn * 32 + j * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * 16 + gq + h * 8;
        *reinterpret_cast<float2*>(dst + (size_t)c * g.CO + co) =
            make_float2(acc[dx][j][2 * h], acc[dx][j][2 * h + 1]);
      }
    }
  }
}

template <int M, bool GN>
__global__ void __launch_bounds__(kThreads)
wgrad_f32_kernel(const float* __restrict__ z, const float* __restrict__ dy,
                 const float* __restrict__ ga, const float* __restrict__ gb,
                 float* __restrict__ part, Geom g) {
  using T = float;
  constexpr int P = M + 2, PITCH = Ty<T>::PITCH;
  __shared__ __align__(16) T Vs[(KP + 2) * PITCH];
  __shared__ __align__(16) T Ds[KP * PITCH];
  const int n_tiles = g.CO / TN;
  const int c0 = (blockIdx.x / n_tiles) * TC, co0 = (blockIdx.x % n_tiles) * TN;
  const int a = blockIdx.y, s = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // 4 c x 4 co each

  float acc[3][4][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dx][r][e] = 0.f;

  const int k0 = (int)((long long)s * g.n_chunks / g.splits);
  const int k1 = (int)((long long)(s + 1) * g.n_chunks / g.splits);
  for (int k = k0; k < k1; ++k) {
    int b, t, x0;
    chunk_coords(g, k, &b, &t, &x0);
    __syncthreads();
    stage_chunk<T, M, GN>(Vs, Ds, z, dy, ga, gb, g, a, b, t, x0, c0, co0);
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < KP; ++p) {
      const float4 d = *reinterpret_cast<const float4*>(Ds + p * PITCH + tx * 4);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 v = *reinterpret_cast<const float4*>(Vs + (p + dx) * PITCH + ty * 4);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[dx][r][0] = fmaf(vv[r], d.x, acc[dx][r][0]);
          acc[dx][r][1] = fmaf(vv[r], d.y, acc[dx][r][1]);
          acc[dx][r][2] = fmaf(vv[r], d.z, acc[dx][r][2]);
          acc[dx][r][3] = fmaf(vv[r], d.w, acc[dx][r][3]);
        }
      }
    }
  }

#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* dst = part + (((size_t)s * P + a) * 3 + dx) * g.C * g.CO;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      store_vec(dst + (size_t)(c0 + ty * 4 + r) * g.CO + co0 + tx * 4, acc[dx][r]);
  }
}

// out[i] = sum_s part[s][i], s in order
__global__ void fold_kernel(const float* __restrict__ part, float* __restrict__ out,
                            size_t n, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * n + i];
  out[i] = acc;
}

template <typename T, int M, bool GN>
int launch(const void* z, const void* dy, const void* ga, const void* gb, void* part,
           void* out, const Geom& g, cudaStream_t stream) {
  constexpr int P = M + 2;
  dim3 grid((g.C / TC) * (g.CO / TN), P, g.splits);
  if constexpr (sizeof(T) == 2)
    wgrad_bf16_kernel<M, GN><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(dy),
        static_cast<const float*>(ga), static_cast<const float*>(gb),
        static_cast<float*>(part), g);
  else
    wgrad_f32_kernel<M, GN><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(z), static_cast<const float*>(dy),
        static_cast<const float*>(ga), static_cast<const float*>(gb),
        static_cast<float*>(part), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)P * 3 * g.C * g.CO;
  fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, g.splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* z, const void* dy, const void* ga, const void* gb, void* part,
             void* out, const Geom& g, int m, int gn, cudaStream_t s) {
  if (m == 2 && !gn) return launch<T, 2, false>(z, dy, ga, gb, part, out, g, s);
  if (m == 2 && gn) return launch<T, 2, true>(z, dy, ga, gb, part, out, g, s);
  if (m == 4 && !gn) return launch<T, 4, false>(z, dy, ga, gb, part, out, g, s);
  if (m == 4 && gn) return launch<T, 4, true>(z, dy, ga, gb, part, out, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// z: (B, H, W, C) (raw x when gn); dy: (B, H, W, CO), both dtype (0 fp32,
// 1 bf16); ga, gb: (B, C) fp32 when gn, else unused; part: (splits, P*3, C,
// CO) fp32 scratch; out: (P*3, C, CO) fp32 with P = m + 2. The Python wrapper
// checks: contiguous, 16-byte aligned, C % 64 == 0, CO % 64 == 0, H % m == 0.
// Returns cudaGetLastError().
int gdt_conv3x3_wgrad(const void* z, const void* dy, const void* ga, const void* gb,
                      void* part, void* out, int B, int H, int W, int C, int CO, int m,
                      int gn, int splits, int dtype, void* stream) {
  const int ht = H / m, n_xc = (W + KP - 1) / KP;
  Geom g{B, H, W, C, CO, ht, n_xc, B * ht * n_xc, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(z, dy, ga, gb, part, out, g, m, gn, s);
  if (dtype == 0) return dispatch<float>(z, dy, ga, gb, part, out, g, m, gn, s);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
