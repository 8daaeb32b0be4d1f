// Single-head attention forward, O = softmax(q k^T * C^-0.5) v, plus the row
// logsumexp, over (B, L, C) tensors, for Hopper (sm_90a).
//
// Replaces generative_detection_tpu/ops/attention.py `_mha_fwd_call` (kernel
// `_mha_fwd_kernel`). The TPU kernel keeps the whole (L, C) K and V of one
// image in VMEM and takes the softmax of a full (bq, L) logit block. On the
// H100 a block has at most 227 KB of shared memory: at C = 512 one bf16 K
// tile of 256 rows alone is 256 KB. So this kernel streams K/V tiles through
// shared memory with an online softmax (running max, running sum, fp32
// accumulator), one block per (q tile, b).
//
// Bound on the H100 at the flagship sites: (B, 4096, 256) is compute-bound
// (4 B L^2 C flops, about 137 GFLOP at B = 8); (B, 256, 512) is memory-bound
// (q, k, v read once, o written once). The bf16 kernel runs both products on
// the tensor cores with mma.sync m16n8k16 and fp32 accumulation; the fp32
// kernel uses FMA. wgmma and TMA are left for later work.
//
// Per K/V tile, each block:
//   1. loads K and V (BK x C) into shared memory,
//   2. S = Q K^T * scale (fp32) -> shared memory,
//   3. per row: m_new = max(m, rowmax S); P = exp(S - m_new) (fp32);
//      l = l * exp(m - m_new) + rowsum(P) from the fp32 P; P is rounded to
//      v's dtype for the next product (the rounding of `_mha_fwd_kernel`),
//   4. O = O * exp(m - m_new) + P V, with O held in registers. At C = 512
//      the O accumulator of a 16-row strip does not fit one warp's registers,
//      so the channels of O are split across two warps.
// At the end O /= l and lse = m + log(l).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps

// ---------------------------------------------------------------------------
// bf16: tensor cores via mma.sync.m16n8k16 (row.col, fp32 accumulate)
// ---------------------------------------------------------------------------

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
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy `rows` rows of C bf16 from global (row stride C) to shared memory
// (row stride ST), 16 bytes per thread per step.
template <int C, int ST>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src, int rows) {
  constexpr int V = C / 8;
  for (int i = threadIdx.x; i < rows * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 8;
    *reinterpret_cast<uint4*>(dst + r * ST + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * C + c);
  }
}

template <int C, int BK>
struct Bf16Cfg {
  static constexpr int BQ = 64;          // 4 strips of 16 query rows
  static constexpr int QST = C + 8;      // padded row strides (elements):
  static constexpr int KST = C + 8;      // each row shifts by 4 banks, so
  static constexpr int VST = C + 8;      // fragment loads are conflict-free
  static constexpr int SST = BK + 4;     // fp32 S
  static constexpr int PST = BK + 8;     // bf16 P
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * (BQ * QST + BK * KST + BK * VST + BQ * PST) +
      sizeof(float) * (BQ * SST + 2 * BQ);
};

template <int C, int BK>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int L,
                     float scale) {
  using Cfg = Bf16Cfg<C, BK>;
  constexpr int BQ = Cfg::BQ, QST = Cfg::QST, KST = Cfg::KST, VST = Cfg::VST;
  constexpr int SST = Cfg::SST, PST = Cfg::PST;
  constexpr int NT = BK / 16;  // S n8-tiles per warp (two warps per strip)
  constexpr int ONT = C / 16;  // O n8-tiles per warp (half the channels)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * QST;
  __nv_bfloat16* Vs = Ks + BK * KST;
  __nv_bfloat16* Ps = Vs + BK * VST;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * PST);
  float* s_alpha = Ss + BQ * SST;
  float* s_l = s_alpha + BQ;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const size_t img = (size_t)b * L * C;

  load_tile_bf16<C, QST>(Qs, q + img + (size_t)q0 * C, BQ);

  // phase 1 (S) layout: warp -> strip warp/2, key columns (warp%2)*BK/2 ..
  const int s_strip = warp / 2, s_n0 = (warp % 2) * (BK / 2);
  // phase 3 (O) layout: warp -> strip warp%4, channels (warp/4)*C/2 ..
  const int o_strip = warp % 4, o_c0 = (warp / 4) * (C / 2);
  // phase 2 (softmax) layout: 4 threads per row
  const int p_row = threadIdx.x / 4, p_part = threadIdx.x % 4;
  float m_run = -INFINITY, l_run = 0.f;

  float acc_o[ONT][4];
#pragma unroll
  for (int j = 0; j < ONT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[j][e] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // previous tile's K, V, P no longer read
    load_tile_bf16<C, KST>(Ks, k + img + (size_t)k0 * C, BK);
    load_tile_bf16<C, VST>(Vs, v + img + (size_t)k0 * C, BK);
    __syncthreads();

    // ---- 1. S = Q K^T * scale
    {
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const __nv_bfloat16* qa = Qs + (s_strip * 16 + g) * QST + 2 * tq;
#pragma unroll 4
      for (int kk = 0; kk < C; kk += 16) {
        uint32_t a[4];
        a[0] = ld32(qa + kk);
        a[1] = ld32(qa + 8 * QST + kk);
        a[2] = ld32(qa + kk + 8);
        a[3] = ld32(qa + 8 * QST + kk + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* kb = Ks + (s_n0 + j * 8 + g) * KST + kk + 2 * tq;
          mma_bf16(acc[j], a, ld32(kb), ld32(kb + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = s_strip * 16 + g, col = s_n0 + j * 8 + 2 * tq;
        Ss[row * SST + col] = acc[j][0] * scale;
        Ss[row * SST + col + 1] = acc[j][1] * scale;
        Ss[(row + 8) * SST + col] = acc[j][2] * scale;
        Ss[(row + 8) * SST + col + 1] = acc[j][3] * scale;
      }
    }
    __syncthreads();

    // ---- 2. online softmax, 4 threads per row
    {
      const float* srow = Ss + p_row * SST;
      float mx = -INFINITY;
      for (int c = p_part; c < BK; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      __nv_bfloat16* prow = Ps + p_row * PST;
      for (int c = p_part; c < BK; c += 4) {
        const float p = expf(srow[c] - m_new);
        prow[c] = __float2bfloat16_rn(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (p_part == 0) s_alpha[p_row] = alpha;
    }
    __syncthreads();

    // ---- 3. O = O * alpha + P V
    {
      const float al0 = s_alpha[o_strip * 16 + g];
      const float al1 = s_alpha[o_strip * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < ONT; ++j) {
        acc_o[j][0] *= al0; acc_o[j][1] *= al0;
        acc_o[j][2] *= al1; acc_o[j][3] *= al1;
      }
      const __nv_bfloat16* pa = Ps + (o_strip * 16 + g) * PST + 2 * tq;
      const int mat = lane >> 3, mi = lane & 7;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4];
        a[0] = ld32(pa + kk);
        a[1] = ld32(pa + 8 * PST + kk);
        a[2] = ld32(pa + kk + 8);
        a[3] = ld32(pa + 8 * PST + kk + 8);
        const __nv_bfloat16* vrow = Vs + (kk + mi + (mat & 1) * 8) * VST + (mat >> 1) * 8;
#pragma unroll
        for (int j = 0; j < ONT; j += 2) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, vrow + o_c0 + j * 8);
          mma_bf16(acc_o[j], a, bfr[0], bfr[1]);
          mma_bf16(acc_o[j + 1], a, bfr[2], bfr[3]);
        }
      }
    }
  }

  if (p_part == 0) {
    s_l[p_row] = l_run;
    lse[(size_t)b * L + q0 + p_row] = m_run + logf(l_run);
  }
  __syncthreads();
  const int row = o_strip * 16 + g;
  const float inv0 = 1.f / s_l[row], inv1 = 1.f / s_l[row + 8];
  __nv_bfloat16* orow = o + img + (size_t)(q0 + row) * C + o_c0 + 2 * tq;
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
        __floats2bfloat162_rn(acc_o[j][0] * inv0, acc_o[j][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * C + j * 8) =
        __floats2bfloat162_rn(acc_o[j][2] * inv1, acc_o[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 32;
constexpr int kF32BK = 32;

template <int C>
struct F32Cfg {
  static constexpr int ST = C + 4;        // rows shift by 4 banks: float4 reads
  static constexpr int SST = kF32BK + 1;  // of 8 consecutive rows are conflict-free
  static constexpr size_t smem_bytes =
      sizeof(float) * ((kF32BQ + 2 * kF32BK) * ST + kF32BQ * SST + 2 * kF32BQ);
};

template <int C>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int rows) {
  constexpr int V = C / 4;
  constexpr int ST = F32Cfg<C>::ST;
  for (int i = threadIdx.x; i < rows * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 4;
    *reinterpret_cast<float4*>(dst + r * ST + c) =
        *reinterpret_cast<const float4*>(src + (size_t)r * C + c);
  }
}

// bf16 rows widened to fp32 in shared memory (the flash variant's upcast).
template <int C>
__device__ __forceinline__ void load_tile_f32(float* dst, const __nv_bfloat16* src, int rows) {
  constexpr int V = C / 8;
  constexpr int ST = F32Cfg<C>::ST;
  for (int i = threadIdx.x; i < rows * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 8;
    const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)r * C + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    *reinterpret_cast<float4*>(dst + r * ST + c) = make_float4(f0.x, f0.y, f1.x, f1.y);
    *reinterpret_cast<float4*>(dst + r * ST + c + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(a, b);
  h[1] = __floats2bfloat162_rn(c, d);
}

// T is the input and output type (fp32 for B1's fp32 path; fp32 or bf16 for
// the forward-only flash variant, which computes in fp32 whatever T is).
// LSE: write the row logsumexp (the flash variant writes none).
template <typename T, int C, bool LSE>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int L, float scale) {
  constexpr int BQ = kF32BQ, BK = kF32BK;
  constexpr int ST = F32Cfg<C>::ST, SST = F32Cfg<C>::SST;
  constexpr int NJ = C / 128;  // float4 column chunks per lane in phase 3

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * ST;
  float* Vs = Ks + BK * ST;
  float* Ss = Vs + BK * ST;
  float* s_alpha = Ss + BQ * SST;
  float* s_l = s_alpha + BQ;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t img = (size_t)b * L * C;
  load_tile_f32<C>(Qs, q + img + (size_t)q0 * C, BQ);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;      // phase 1
  const int p_row = threadIdx.x / 8, p_part = threadIdx.x % 8;  // phase 2
  float m_run = -INFINITY, l_run = 0.f;
  float acc[4][NJ][4];                                          // phase 3
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_tile_f32<C>(Ks, k + img + (size_t)k0 * C, BK);
    load_tile_f32<C>(Vs, v + img + (size_t)k0 * C, BK);
    __syncthreads();

    // ---- 1. S[ty + 16a][tx + 16b] = q . k * scale
    {
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      const float* qr0 = Qs + ty * ST;
      const float* qr1 = Qs + (ty + 16) * ST;
      const float* kr0 = Ks + tx * ST;
      const float* kr1 = Ks + (tx + 16) * ST;
#pragma unroll 4
      for (int d = 0; d < C; d += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(qr0 + d);
        const float4 a1 = *reinterpret_cast<const float4*>(qr1 + d);
        const float4 b0 = *reinterpret_cast<const float4*>(kr0 + d);
        const float4 b1 = *reinterpret_cast<const float4*>(kr1 + d);
        s[0][0] += a0.x * b0.x + a0.y * b0.y + a0.z * b0.z + a0.w * b0.w;
        s[0][1] += a0.x * b1.x + a0.y * b1.y + a0.z * b1.z + a0.w * b1.w;
        s[1][0] += a1.x * b0.x + a1.y * b0.y + a1.z * b0.z + a1.w * b0.w;
        s[1][1] += a1.x * b1.x + a1.y * b1.y + a1.z * b1.z + a1.w * b1.w;
      }
      Ss[ty * SST + tx] = s[0][0] * scale;
      Ss[ty * SST + tx + 16] = s[0][1] * scale;
      Ss[(ty + 16) * SST + tx] = s[1][0] * scale;
      Ss[(ty + 16) * SST + tx + 16] = s[1][1] * scale;
    }
    __syncthreads();

    // ---- 2. online softmax, 8 threads per row; P overwrites S in place
    {
      float* srow = Ss + p_row * SST;
      float mx = -INFINITY;
      for (int c = p_part; c < BK; c += 8) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int c = p_part; c < BK; c += 8) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (p_part == 0) s_alpha[p_row] = alpha;
    }
    __syncthreads();

    // ---- 3. rows warp*4 .. +3, columns lane*4 + 128 j
    {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float al = s_alpha[warp * 4 + r];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][e] *= al;
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float p[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) p[r] = Ss[(warp * 4 + r) * SST + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * ST + lane * 4 + 128 * j);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][j][0] += p[r] * vv.x;
            acc[r][j][1] += p[r] * vv.y;
            acc[r][j][2] += p[r] * vv.z;
            acc[r][j][3] += p[r] * vv.w;
          }
        }
      }
    }
  }

  if (p_part == 0) {
    s_l[p_row] = l_run;
    if (LSE) lse[(size_t)b * L + q0 + p_row] = m_run + logf(l_run);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = warp * 4 + r;
    const float inv = 1.f / s_l[row];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store4(o + img + (size_t)(q0 + row) * C + lane * 4 + 128 * j, acc[r][j][0] * inv,
             acc[r][j][1] * inv, acc[r][j][2] * inv, acc[r][j][3] * inv);
    }
  }
}

template <int C>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                int L, float scale, cudaStream_t stream) {
  constexpr int BK = C > 256 ? 32 : 64;
  using Cfg = Bf16Cfg<C, BK>;
  auto kernel = attn_fwd_bf16_kernel<C, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L / Cfg::BQ, B);
  kernel<<<grid, kThreads, Cfg::smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), L, scale);
  return (int)cudaGetLastError();
}

template <typename T, int C, bool LSE>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
               int L, float scale, cudaStream_t stream) {
  auto kernel = attn_fwd_f32_kernel<T, C, LSE>;
  const size_t smem = F32Cfg<C>::smem_bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L / kF32BQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), L, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (B, L, C) contiguous, fp32 (dtype 0) or bf16 (dtype 1); lse:
// (B, L) fp32. Takes C in {128, 256, 512} and L % 64 == 0 (the Python wrapper
// checks and raises outside them). Returns cudaGetLastError().
int gdt_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                      int B, int L, int C, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (C) {
      case 128: return launch_bf16<128>(q, k, v, o, lse, B, L, scale, s);
      case 256: return launch_bf16<256>(q, k, v, o, lse, B, L, scale, s);
      case 512: return launch_bf16<512>(q, k, v, o, lse, B, L, scale, s);
    }
  } else if (dtype == 0) {
    switch (C) {
      case 128: return launch_f32<float, 128, true>(q, k, v, o, lse, B, L, scale, s);
      case 256: return launch_f32<float, 256, true>(q, k, v, o, lse, B, L, scale, s);
      case 512: return launch_f32<float, 512, true>(q, k, v, o, lse, B, L, scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The forward-only flash variant (B5): q, k, v, o as above in fp32 (dtype 0)
// or bf16 (dtype 1), computed in fp32 throughout (products and P), no lse.
// Replaces generative_detection_tpu/ops/attention.py `_attention_pallas`
// (kernel `_flash_kernel`), which upcasts q, k, v to fp32 and runs both
// products in fp32. It is the fp32 kernel above reading bf16 rows into fp32
// shared memory. Same shape limits as gdt_attention_fwd.
int gdt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                            int L, int C, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (C) {
      case 128: return launch_f32<float, 128, false>(q, k, v, o, nullptr, B, L, scale, s);
      case 256: return launch_f32<float, 256, false>(q, k, v, o, nullptr, B, L, scale, s);
      case 512: return launch_f32<float, 512, false>(q, k, v, o, nullptr, B, L, scale, s);
    }
  } else if (dtype == 1) {
    switch (C) {
      case 128:
        return launch_f32<__nv_bfloat16, 128, false>(q, k, v, o, nullptr, B, L, scale, s);
      case 256:
        return launch_f32<__nv_bfloat16, 256, false>(q, k, v, o, nullptr, B, L, scale, s);
      case 512:
        return launch_f32<__nv_bfloat16, 512, false>(q, k, v, o, nullptr, B, L, scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
