// Row-Winograd 3x3 stride-1 SAME convolution over NHWC in fp32, with an
// optional GroupNorm+SiLU prologue, for Hopper (sm_90a):
//
//   F(2,3) (MODE 2) and F(4,3) (MODE 4): Winograd along rows, direct along
//     columns, for the M = MODE output rows m t .. m t + M - 1 of "t-row" t:
//       V_a[t]  = sum_u BT[a, u] z[M t + u - 1]      (fp32 sum)
//       G_a     = sum_dx shift_dx(V_a) @ U[a, dx]    (fp32 accumulate)
//       out[M t + i] = sum_a AT[i, a] G_a + bias     (fp32)
//     with U[a, dx] = sum_ky G[a, ky] K[ky, dx] computed outside (a torch op).
//
// Replaces, in fp32 (bf16 runs conv3x3_wino.cu, TMA + wgmma; so does the
// fp32 direct form with the prologue, B6, on split precision):
// generative_detection_tpu/ops/winograd_pallas.py `_wino_rows_pallas`
// (kernel `_wino_rows_kernel`), with or without the prologue; the same
// launch with the rotated, io-swapped kernel is the dgrad.
//
// The arithmetic is the TPU kernel's in fp32: rows outside the image are
// zero AFTER the activation, products accumulate in fp32, and the output
// transform and bias run in fp32 (winograd_pallas.py:235-248).
//
// Design. A block takes BM = 64 output positions of one image (TT t-rows of
// TW columns, TT * TW <= 64) and BN = 64 output channels, and walks the input
// channels in chunks of KC = 16. Per chunk it computes V (all points, TT rows
// of TW + 2 columns: the column halo is a plain offset read of shared
// memory, with zeros at the image edge; the TPU kernel's masked rolls are not
// needed) and copies the chunk of U with cp.async, then accumulates
// sum_dx V_a[slot + dx - 1] U[a, dx] for every point on the CUDA cores (FMA),
// each thread a 4 x 4 (positions x channels) tile per point. The last column
// tile of a row may run past the image (any W): its columns >= W read as
// zero and are not stored. Every output element is written by one thread: no
// atomics.
//
// Bound on the H100: 67 TFLOP/s of fp32 FMA, far below the tensor cores'.
// This kernel is the card-against-CPU yardstick in fp32, not a path users
// take for speed: no TMA, no pipelining across chunks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "winograd.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps; a block takes BM = 64 output positions
constexpr int BN = 64;         // output channels per block
constexpr int KC = 16;         // input channels per chunk
constexpr int VP = KC + 4;     // padded shared-memory pitches (floats)
constexpr int UP = BN + 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

struct Geom {
  int H, W, C, CO;
  int HT;      // t-rows per image: H / M
  int tw, tt;  // block tile: tt t-rows of tw columns
  int n_xt;    // column tiles per image: ceil(W / tw)
};

// Stage V for input channels [c0, c0 + KC) into Vs[a][slot][k]: every slot
// of the block's TT x (TW + 2) window, each thread 4 channels at a time.
template <int M, bool GN>
__device__ __forceinline__ void stage_v(float* Vs, const float* __restrict__ x,
                                        const float* __restrict__ ga,
                                        const float* __restrict__ gb, const Geom& g, int b,
                                        int t0, int x0, int c0, int slots) {
  constexpr int P = M + 2, NV = KC / 4;
  for (int it = threadIdx.x; it < slots * NV; it += kThreads) {
    const int s = it / NV, cv = (it % NV) * 4;
    const int tl = s / (g.tw + 2), xs = s % (g.tw + 2) - 1;
    const int t = t0 + tl, xx = x0 + xs;
    const bool col_ok = xx >= 0 && xx < g.W && t < g.HT;
    float gav[4], gbv[4];
    if (GN) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gav[j] = ga[(size_t)b * g.C + c0 + cv + j];
        gbv[j] = gb[(size_t)b * g.C + c0 + cv + j];
      }
    }
    float r[P][4];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int y = M * t + u - 1;
      if (col_ok && y >= 0 && y < g.H) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            x + (((size_t)b * g.H + y) * g.W + xx) * g.C + c0 + cv);
        r[u][0] = v4.x; r[u][1] = v4.y; r[u][2] = v4.z; r[u][3] = v4.w;
        if (GN) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = r[u][j] * gav[j] + gbv[j];
            r[u][j] = v / (1.f + expf(-v));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int a = 0; a < P; ++a) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < P; ++u) acc = fmaf(bt_c(M, a, u), r[u][j], acc);
        v[j] = acc;
      }
      *reinterpret_cast<float4*>(Vs + ((size_t)a * slots + s) * VP + cv) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Copy the chunk U[:, :, c0:c0+KC, co0:co0+BN] into Us[(a*3+dx)*KC + k][n].
template <int P>
__device__ __forceinline__ void stage_u(float* Us, const float* __restrict__ U, const Geom& g,
                                        int c0, int co0) {
  constexpr int NV = BN / 4;
  for (int it = threadIdx.x; it < P * 3 * KC * NV; it += kThreads) {
    const int row = it / NV, cv = (it % NV) * 4;
    const int ad = row / KC, k = row % KC;
    cp_async16(Us + row * UP + cv, U + ((size_t)ad * g.C + c0 + k) * g.CO + co0 + cv);
  }
}

// Output position of block row r (0..BM-1): false when the row is padding
// or a column past the image.
__device__ __forceinline__ bool row_pos(const Geom& g, int r, int t0, int x0, int* t, int* xx,
                                        int* slot) {
  const int tl = r / g.tw, xl = r % g.tw;
  *t = t0 + tl;
  *xx = x0 + xl;
  const bool ok = tl < g.tt && *t < g.HT && *xx < g.W;
  *slot = ok ? tl * (g.tw + 2) + xl + 1 : 1;
  return ok;
}

// Output row i of one element from its points' accumulators G_a = acc[a],
// plus the bias, in fp32.
template <int M, int P>
__device__ __forceinline__ float out_value(const float (&g)[P], int i, float bias) {
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < P; ++a) s = fmaf(at_c(M, i, a), g[a], s);
  return s + bias;
}

template <int M, bool GN>
__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ U,
                   const float* __restrict__ bias, const float* __restrict__ ga,
                   const float* __restrict__ gb, float* __restrict__ out, Geom g) {
  constexpr int P = M + 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = g.tt * (g.tw + 2);
  float* Us = reinterpret_cast<float*>(smem_raw);
  float* Vs = Us + P * 3 * KC * UP;

  const int b = blockIdx.z, co0 = blockIdx.y * BN;
  const int t0 = (blockIdx.x / g.n_xt) * g.tt, x0 = (blockIdx.x % g.n_xt) * g.tw;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  int rslot[4];
  bool rok[4];
  int rt[4], rx[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) rok[rr] = row_pos(g, ty * 4 + rr, t0, x0, &rt[rr], &rx[rr], &rslot[rr]);

  float acc[P][4][4];
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][rr][e] = 0.f;

  for (int c0 = 0; c0 < g.C; c0 += KC) {
    __syncthreads();
    stage_u<P>(Us, U, g, c0, co0);
    stage_v<M, GN>(Vs, x, ga, gb, g, b, t0, x0, c0, slots);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int a = 0; a < P; ++a) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* vb = Vs + ((size_t)a * slots + dx - 1) * VP;
        const float* ub = Us + (a * 3 + dx) * KC * UP + tx * 4;
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          const float4 u = *reinterpret_cast<const float4*>(ub + k * UP);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float v = vb[rslot[rr] * VP + k];
            float* ac = acc[a][rr];
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
        float ge[P];
#pragma unroll
        for (int a = 0; a < P; ++a) ge[a] = acc[a][rr][e];
        v[e] = out_value<M, P>(ge, i, bb[e]);
      }
      *reinterpret_cast<float4*>(
          out + (((size_t)b * g.H + M * rt[rr] + i) * g.W + rx[rr]) * g.CO + co) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int M, bool GN>
int launch(const float* x, const float* U, const float* bias, const float* ga, const float* gb,
           float* out, int B, const Geom& g, cudaStream_t stream) {
  constexpr int P = M + 2;
  const size_t smem =
      sizeof(float) * ((size_t)P * 3 * KC * UP + (size_t)P * g.tt * (g.tw + 2) * VP);
  dim3 grid(g.n_xt * ((g.HT + g.tt - 1) / g.tt), g.CO / BN, B);
  auto kernel = conv3x3_f32_kernel<M, GN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(x, U, bias, ga, gb, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, C) fp32; U: (P*3, C, CO) fp32, the row-Winograd U[a, dx]
// with P = mode + 2 (mode 2 or 4: the direct form runs in conv3x3_wino.cu);
// bias: (CO,); ga, gb: (B, C) GroupNorm affine when gn, else unused; out:
// (B, H, W, CO). The Python wrapper checks the rest: contiguous, 16-byte
// aligned, C % 16 == 0, CO % 64 == 0, H % mode == 0, tw * tt <= 64. Returns
// cudaGetLastError().
int gdt_conv3x3_fwd(const float* x, const float* U, const float* bias, const float* ga,
                    const float* gb, float* out, int B, int H, int W, int C, int CO, int mode,
                    int gn, int tw, int tt, void* stream) {
  const Geom g{H, W, C, CO, H / mode, tw, tt, (W + tw - 1) / tw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 2 && !gn) return launch<2, false>(x, U, bias, ga, gb, out, B, g, s);
  if (mode == 2 && gn) return launch<2, true>(x, U, bias, ga, gb, out, B, g, s);
  if (mode == 4 && !gn) return launch<4, false>(x, U, bias, ga, gb, out, B, g, s);
  if (mode == 4 && gn) return launch<4, true>(x, U, bias, ga, gb, out, B, g, s);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
