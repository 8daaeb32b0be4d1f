// 3x3 stride-1 SAME convolution over NHWC, with an optional GroupNorm+SiLU
// prologue, for Hopper (sm_90a). One template, three row formulations:
//
//   direct  (MODE 1): out[y] = sum_{dy} z[y + dy - 1] (*) K[dy]
//   F(2,3)  (MODE 2) and F(4,3) (MODE 4): Winograd along rows, direct along
//     columns, for the M = MODE output rows m t .. m t + M - 1 of "t-row" t:
//       V_a[t]  = sum_u BT[a, u] z[M t + u - 1]      (fp32 sum, cast to T)
//       G_a     = sum_dx shift_dx(V_a) @ U[a, dx]    (fp32 accumulate)
//       out[M t + i] = sum_a AT[i, a] G_a + bias     (fp32, cast to T)
//     with U[a, dx] = sum_ky G[a, ky] K[ky, dx] computed outside (a torch op).
//
// Replaces:
//   - generative_detection_tpu/ops/fused_conv.py `_fused_pallas` (kernel
//     `_fused_kernel`): direct mode with the prologue z = silu(x a + b), and
//     optionally writing z (`emit_z`, the training variant's saved
//     activation);
//   - generative_detection_tpu/ops/winograd_pallas.py `_wino_rows_pallas`
//     (kernel `_wino_rows_kernel`) in fp32: MODE 2/4, with or without the
//     prologue; the same launch with the rotated, io-swapped kernel is the
//     dgrad. bf16 MODE 2/4 runs conv3x3_wino.cu (TMA + wgmma); the bf16
//     template here is instantiated for the direct mode only.
//
// The rounding is the TPU kernels': the prologue runs in fp32 and is rounded
// to T (the kernels keep z in a T scratch), rows and columns outside the
// image are zero AFTER the activation (fused_conv.py:145-161), V_a is summed
// in fp32 and cast to T before the product (winograd_pallas.py:198-213),
// products accumulate in fp32, and the output transform and bias run in
// fp32 (winograd_pallas.py:235-248).
//
// Design. A block takes BM = 64 output positions of one image (TT t-rows of
// TW columns, TT * TW <= 64) and BN = 64 output channels, and walks the input
// channels in chunks of KC = 16. Per chunk it computes V (all points, TT rows
// of TW + 2 columns: the column halo is a plain offset read of shared
// memory, with zeros at the image edge; the TPU kernel's masked rolls are not
// needed) and copies the chunk of U with cp.async, then accumulates
// sum_dx V_a[slot + dx - 1] U[a, dx] for every point. bf16 runs on the tensor
// cores (mma.sync m16n8k16, fp32 accumulate, operands by ldmatrix); fp32 uses
// FMA. Every output element is written by one thread: no atomics.
//
// Bound on the H100: at the flagship sites this is compute-bound on the
// direct-conv yardstick (2 * 9 * H * W * C * CO flops per image against
// reading x and writing out once); F(4,3) does 6/12 of direct's products.
// The kernel is a first, simple version: no wgmma/TMA, no pipelining across
// chunks, 64 x 64 tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int BM = 64;         // output positions per block
constexpr int BN = 64;         // output channels per block
constexpr int KC = 16;         // input channels per chunk

__constant__ float kBT2[4][4] = {{1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
__constant__ float kAT2[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
__constant__ float kBT4[6][6] = {
    {4, 0, -5, 0, 1, 0}, {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},
    {0, -2, -1, 2, 1, 0}, {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}};
__constant__ float kAT4[4][6] = {
    {1, 1, 1, 1, 1, 0}, {0, 1, -1, 2, -2, 0}, {0, 1, 1, 4, 4, 0}, {0, 1, -1, 8, -8, 1}};

template <int MODE>
__device__ __forceinline__ float bt(int a, int u) {
  return MODE == 2 ? kBT2[a][u] : kBT4[a][u];
}
template <int MODE>
__device__ __forceinline__ float at(int i, int a) {
  return MODE == 2 ? kAT2[i][a] : kAT4[i][a];
}

// Per element type: VEC elements per 16-byte access; padded shared-memory
// pitches (elements) that keep ldmatrix/fragment reads conflict-free.
template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static constexpr int VEC = 8, VP = KC + 8, UP = BN + 8;
};
template <> struct Ty<float> {
  static constexpr int VEC = 4, VP = KC + 4, UP = BN + 4;
};

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

// fp32 value rounded through T (identity for fp32)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

struct Geom {
  int H, W, C, CO;
  int HT;      // t-rows per image: H / M
  int tw, tt;  // block tile: tt t-rows of tw columns
  int n_xt;    // column tiles per image: W / tw
};

// Points per t-row: 3 input rows for direct, M + 2 for F(M,3).
template <int MODE> struct Pts { static constexpr int P = MODE == 1 ? 3 : MODE + 2; };

// Stage V for input channels [c0, c0 + KC) into Vs[a][slot][k]: every slot
// of the block's TT x (TW + 2) window, each thread VEC channels at a time.
template <typename T, int MODE, bool GN, bool EMIT_Z>
__device__ __forceinline__ void stage_v(T* Vs, const T* __restrict__ x,
                                        const float* __restrict__ ga,
                                        const float* __restrict__ gb, T* __restrict__ zout,
                                        const Geom& g, int b, int t0, int x0, int c0,
                                        int slots, bool write_z) {
  constexpr int P = Pts<MODE>::P, M = MODE, VEC = Ty<T>::VEC, VP = Ty<T>::VP;
  constexpr int NV = KC / VEC;
  for (int it = threadIdx.x; it < slots * NV; it += kThreads) {
    const int s = it / NV, cv = (it % NV) * VEC;
    const int tl = s / (g.tw + 2), xs = s % (g.tw + 2) - 1;
    const int t = t0 + tl, xx = x0 + xs;
    const bool col_ok = xx >= 0 && xx < g.W && t < g.HT;
    float gav[VEC], gbv[VEC];
    if (GN) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        gav[j] = ga[(size_t)b * g.C + c0 + cv + j];
        gbv[j] = gb[(size_t)b * g.C + c0 + cv + j];
      }
    }
    float r[P][VEC];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int y = M * t + u - 1;
      if (col_ok && y >= 0 && y < g.H) {
        load_vec(x + (((size_t)b * g.H + y) * g.W + xx) * g.C + c0 + cv, r[u]);
        if (GN) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float v = r[u][j] * gav[j] + gbv[j];
            r[u][j] = round_to(v / (1.f + expf(-v)), x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) r[u][j] = 0.f;
      }
    }
    if (EMIT_Z && write_z && col_ok && xs >= 0 && xs < g.tw)
      store_vec(zout + (((size_t)b * g.H + t) * g.W + xx) * g.C + c0 + cv, r[1]);
#pragma unroll
    for (int a = 0; a < P; ++a) {
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if constexpr (MODE == 1) {
          v[j] = r[a][j];
        } else {
          float acc = 0.f;
#pragma unroll
          for (int u = 0; u < P; ++u) acc = fmaf(bt<MODE>(a, u), r[u][j], acc);
          v[j] = acc;
        }
      }
      store_vec(Vs + ((size_t)a * slots + s) * VP + cv, v);  // rounds to T
    }
  }
}

// Copy the chunk U[:, :, c0:c0+KC, co0:co0+BN] into Us[(a*3+dx)*KC + k][n].
template <typename T, int P>
__device__ __forceinline__ void stage_u(T* Us, const T* __restrict__ U, const Geom& g,
                                        int c0, int co0) {
  constexpr int VEC = Ty<T>::VEC, UP = Ty<T>::UP, NV = BN / VEC;
  for (int it = threadIdx.x; it < P * 3 * KC * NV; it += kThreads) {
    const int row = it / NV, cv = (it % NV) * VEC;
    const int ad = row / KC, k = row % KC;
    cp_async16(Us + row * UP + cv, U + ((size_t)ad * g.C + c0 + k) * g.CO + co0 + cv);
  }
}

// Output position of block row r (0..BM-1): false when the row is padding.
__device__ __forceinline__ bool row_pos(const Geom& g, int r, int t0, int x0, int* t, int* xx,
                                        int* slot) {
  const int tl = r / g.tw, xl = r % g.tw;
  *t = t0 + tl;
  *xx = x0 + xl;
  const bool ok = tl < g.tt && *t < g.HT;
  *slot = ok ? tl * (g.tw + 2) + xl + 1 : 1;
  return ok;
}

// Output row i of one element from its points' accumulators G_a = acc[a],
// plus the bias, in fp32 (direct mode keeps one accumulator).
template <int MODE, int NA>
__device__ __forceinline__ float out_value(const float (&g)[NA], int i, float bias) {
  if constexpr (MODE == 1) {
    return g[0] + bias;
  } else {
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) s = fmaf(at<MODE>(i, a), g[a], s);
    return s + bias;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int MODE, bool GN, bool EMIT_Z>
__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ U,
                    const float* __restrict__ bias, const float* __restrict__ ga,
                    const float* __restrict__ gb, __nv_bfloat16* __restrict__ out,
                    __nv_bfloat16* __restrict__ zout, Geom g) {
  using T = __nv_bfloat16;
  constexpr int P = Pts<MODE>::P, NA = MODE == 1 ? 1 : P, M = MODE;
  constexpr int VP = Ty<T>::VP, UP = Ty<T>::UP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = g.tt * (g.tw + 2);
  T* Us = reinterpret_cast<T*>(smem_raw);
  T* Vs = Us + P * 3 * KC * UP;

  const int b = blockIdx.z, co0 = blockIdx.y * BN;
  const int t0 = (blockIdx.x / g.n_xt) * g.tt, x0 = (blockIdx.x % g.n_xt) * g.tw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;  // 16-row strip, 32-column half
  const int gq = lane >> 2, tq = lane & 3;

  // this lane's ldmatrix row (A operand) and its V slot
  int t_, x_, a_slot;
  row_pos(g, wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, t0, x0, &t_, &x_, &a_slot);
  const int a_koff = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;

  float acc[NA][4][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;

  for (int c0 = 0; c0 < g.C; c0 += KC) {
    __syncthreads();  // the previous chunk is no longer read
    stage_u<T, P>(Us, U, g, c0, co0);
    stage_v<T, MODE, GN, EMIT_Z>(Vs, x, ga, gb, zout, g, b, t0, x0, c0, slots,
                                 blockIdx.y == 0);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int a = 0; a < P; ++a) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t af[4];
        ldmatrix_x4(af, Vs + ((size_t)a * slots + a_slot + dx - 1) * VP + a_koff);
        const T* ub = Us + ((a * 3 + dx) * KC + b_k) * UP + wn * 32 + b_n;
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, ub + j * 8);
          mma_bf16(acc[MODE == 1 ? 0 : a][j], af, bf[0], bf[1]);
          mma_bf16(acc[MODE == 1 ? 0 : a][j + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

  // epilogue: output transform + bias in fp32, one rounding to bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int t, xx, slot;
    if (!row_pos(g, wm * 16 + gq + h * 8, t0, x0, &t, &xx, &slot)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + wn * 32 + j * 8 + 2 * tq;
      const float b0 = bias[co], b1 = bias[co + 1];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float g0[NA], g1[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          g0[a] = acc[a][j][2 * h];
          g1[a] = acc[a][j][2 * h + 1];
        }
        const float v0 = out_value<MODE, NA>(g0, i, b0);
        const float v1 = out_value<MODE, NA>(g1, i, b1);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * g.H + M * t + i) * g.W + xx) * g.CO + co) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA, each thread a 4 x 4 (positions x channels) tile per point
// ---------------------------------------------------------------------------

template <int MODE, bool GN, bool EMIT_Z>
__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ U,
                   const float* __restrict__ bias, const float* __restrict__ ga,
                   const float* __restrict__ gb, float* __restrict__ out,
                   float* __restrict__ zout, Geom g) {
  using T = float;
  constexpr int P = Pts<MODE>::P, NA = MODE == 1 ? 1 : P, M = MODE;
  constexpr int VP = Ty<T>::VP, UP = Ty<T>::UP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = g.tt * (g.tw + 2);
  T* Us = reinterpret_cast<T*>(smem_raw);
  T* Vs = Us + P * 3 * KC * UP;

  const int b = blockIdx.z, co0 = blockIdx.y * BN;
  const int t0 = (blockIdx.x / g.n_xt) * g.tt, x0 = (blockIdx.x % g.n_xt) * g.tw;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  int rslot[4];
  bool rok[4];
  int rt[4], rx[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) rok[rr] = row_pos(g, ty * 4 + rr, t0, x0, &rt[rr], &rx[rr], &rslot[rr]);

  float acc[NA][4][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][rr][e] = 0.f;

  for (int c0 = 0; c0 < g.C; c0 += KC) {
    __syncthreads();
    stage_u<T, P>(Us, U, g, c0, co0);
    stage_v<T, MODE, GN, EMIT_Z>(Vs, x, ga, gb, zout, g, b, t0, x0, c0, slots,
                                 blockIdx.y == 0);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int a = 0; a < P; ++a) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const T* vb = Vs + ((size_t)a * slots + dx - 1) * VP;
        const T* ub = Us + (a * 3 + dx) * KC * UP + tx * 4;
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          const float4 u = *reinterpret_cast<const float4*>(ub + k * UP);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float v = vb[rslot[rr] * VP + k];
            float* ac = acc[MODE == 1 ? 0 : a][rr];
            ac[0] = fmaf(v, u.x, ac[0]);
            ac[1] = fmaf(v, u.y, ac[1]);
            ac[2] = fmaf(v, u.z, ac[2]);
            ac[3] = fmaf(v, u.w, ac[3]);
          }
        }
      }
    }
  }

  const int co = co0 + tx * 4;
  const float4 bv = *reinterpret_cast<const float4*>(bias + co);
  const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    if (!rok[rr]) continue;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float ge[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) ge[a] = acc[a][rr][e];
        v[e] = out_value<MODE, NA>(ge, i, bb[e]);
      }
      store_vec(out + (((size_t)b * g.H + M * rt[rr] + i) * g.W + rx[rr]) * g.CO + co, v);
    }
  }
}

template <typename T>
size_t smem_bytes(int P, int slots) {
  return sizeof(T) * ((size_t)P * 3 * KC * Ty<T>::UP + (size_t)P * slots * Ty<T>::VP);
}

template <typename T, int MODE, bool GN, bool EMIT_Z>
int launch(const void* x, const void* U, const void* bias, const void* ga, const void* gb,
           void* out, void* zout, int B, const Geom& g, cudaStream_t stream) {
  constexpr int P = Pts<MODE>::P;
  const size_t smem = smem_bytes<T>(P, g.tt * (g.tw + 2));
  dim3 grid(g.n_xt * ((g.HT + g.tt - 1) / g.tt), g.CO / BN, B);
  if constexpr (sizeof(T) == 2) {
    auto kernel = conv3x3_bf16_kernel<MODE, GN, EMIT_Z>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(U),
        static_cast<const float*>(bias), static_cast<const float*>(ga),
        static_cast<const float*>(gb), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(zout), g);
  } else {
    auto kernel = conv3x3_f32_kernel<MODE, GN, EMIT_Z>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(U),
        static_cast<const float*>(bias), static_cast<const float*>(ga),
        static_cast<const float*>(gb), static_cast<float*>(out), static_cast<float*>(zout), g);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* U, const void* bias, const void* ga, const void* gb,
             void* out, void* zout, int B, const Geom& g, int mode, int gn, int emit_z,
             cudaStream_t s) {
  if (mode == 1 && gn && !emit_z)
    return launch<T, 1, true, false>(x, U, bias, ga, gb, out, zout, B, g, s);
  if (mode == 1 && gn && emit_z)
    return launch<T, 1, true, true>(x, U, bias, ga, gb, out, zout, B, g, s);
  if (emit_z) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {  // bf16 rows run conv3x3_wino.cu
    if (mode == 2 && !gn) return launch<T, 2, false, false>(x, U, bias, ga, gb, out, zout, B, g, s);
    if (mode == 2 && gn) return launch<T, 2, true, false>(x, U, bias, ga, gb, out, zout, B, g, s);
    if (mode == 4 && !gn) return launch<T, 4, false, false>(x, U, bias, ga, gb, out, zout, B, g, s);
    if (mode == 4 && gn) return launch<T, 4, true, false>(x, U, bias, ga, gb, out, zout, B, g, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: (B, H, W, C); U: (P*3, C, CO) with P = 3 (mode 1, the direct kernel
// K[dy, dx]) or mode + 2 (the row-Winograd U[a, dx]); bias: (CO,) fp32;
// ga, gb: (B, C) fp32 GroupNorm affine when gn, else unused; out:
// (B, H, W, CO); zout: (B, H, W, C) when emit_z (mode 1 with gn only).
// dtype 0 fp32, 1 bf16 (mode 1 only). The Python wrapper checks the rest: contiguous,
// 16-byte aligned, C % 16 == 0, CO % 64 == 0, H % mode == 0, tw * tt <= 64,
// W % tw == 0. Returns cudaGetLastError().
int gdt_conv3x3_fwd(const void* x, const void* U, const void* bias, const void* ga,
                    const void* gb, void* out, void* zout, int B, int H, int W, int C,
                    int CO, int mode, int gn, int emit_z, int tw, int tt, int dtype,
                    void* stream) {
  Geom g{H, W, C, CO, H / mode, tw, tt, W / tw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, U, bias, ga, gb, out, zout, B, g, mode, gn, emit_z, s);
  if (dtype == 0)
    return dispatch<float>(x, U, bias, ga, gb, out, zout, B, g, mode, gn, emit_z, s);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
