// Single-head attention backward over (B, L, C) tensors, for Hopper (sm_90a):
// dq, dk, dv of O = softmax(q k^T * scale) v from q, k, v, dO, the forward's
// row logsumexp `lse` and di = rowsum(dO * O), both (B, L) fp32.
//
// Replaces generative_detection_tpu/ops/attention.py `_mha_bwd_call` (kernel
// `_mha_bwd_kernel`). The TPU kernel runs one pass over q blocks with the
// whole (L, C) K and V of an image and two (L, C) fp32 dK/dV accumulators in
// VMEM (about 16 MiB at 4096 x 256). A Hopper block has 227 KB of shared
// memory and 64K registers, so this follows the FlashAttention-2 split into
// two launches, both deterministic (no atomics):
//
//   attn_bwd_dkdv: block (key tile, b, channel slice) keeps its BK rows of K
//     and V in shared memory and walks all q tiles:
//       S^T  = K Q^T * scale,  P^T = exp(S^T - lse)            (fp32)
//       dV  += bf(P^T) dO                                      (fp32 acc)
//       dP^T = V dO^T,         dS^T = bf(P^T (dP^T - di) * scale)
//       dK  += dS^T Q                                          (fp32 acc)
//     The dK/dV accumulators of one block cover a slice of CS = 128 output
//     channels, which keeps them in registers at C = 512; S^T and dP^T (full
//     C contractions) are recomputed once per slice.
//   attn_bwd_dq: block (q tile, b, channel slice) keeps its BQ rows of Q and
//     dO and walks all key tiles: S, P, dP, dS as above, dQ += dS K.
//
// bf() is the rounding of `_mha_bwd_kernel`: P is cast to dO's dtype before
// the dV product and dS to q's dtype before the dK and dQ products; every
// product accumulates in fp32 and dq, dk, dv are written in q's dtype.
//
// Bound on the H100: at (B, 4096, 256) the backward is compute-bound (five
// L x L x C products, 10 B L^2 C flops); at (B, 256, 512) memory-bound. The
// bf16 kernels run every product on the tensor cores (mma.sync m16n8k16,
// fp32 accumulate) and do about 18 B L^2 C flops at C = 256 (the recomputed
// S and dP); the fp32 kernels use FMA. wgmma and TMA are left for later work.

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

__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int rows) {
  for (int i = threadIdx.x; i < rows; i += kThreads) dst[i] = src[i];
}

// Phase A, shared by both bf16 kernels. The block computes two (64 x BN)
// fp32 products that contract over all C channels,
//   X = A1 B1^T  and  Y = A2 B2^T,
// with A1, A2 (64 x C) and B1, B2 (BN x C) row-major bf16 in shared memory
// (row stride ST). Warp w owns rows 16 (w / 2) .. +15 and columns
// (w % 2) BN / 2 .. +BN/2-1, so X and Y come out in the same fragment layout
// and the caller combines them element by element.
template <int C, int ST, int BN>
__device__ __forceinline__ void phase_a(const __nv_bfloat16* A1, const __nv_bfloat16* B1,
                                        const __nv_bfloat16* A2, const __nv_bfloat16* B2,
                                        float (*x)[4], float (*y)[4]) {
  constexpr int NT = BN / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int strip = warp / 2, n0 = (warp % 2) * (BN / 2);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) { x[j][e] = 0.f; y[j][e] = 0.f; }
  const __nv_bfloat16* a1 = A1 + (strip * 16 + g) * ST + 2 * tq;
  const __nv_bfloat16* a2 = A2 + (strip * 16 + g) * ST + 2 * tq;
#pragma unroll 2
  for (int kk = 0; kk < C; kk += 16) {
    uint32_t f1[4], f2[4];
    f1[0] = ld32(a1 + kk);
    f1[1] = ld32(a1 + 8 * ST + kk);
    f1[2] = ld32(a1 + kk + 8);
    f1[3] = ld32(a1 + 8 * ST + kk + 8);
    f2[0] = ld32(a2 + kk);
    f2[1] = ld32(a2 + 8 * ST + kk);
    f2[2] = ld32(a2 + kk + 8);
    f2[3] = ld32(a2 + 8 * ST + kk + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int off = (n0 + j * 8 + g) * ST + kk + 2 * tq;
      mma_bf16(x[j], f1, ld32(B1 + off), ld32(B1 + off + 8));
      mma_bf16(y[j], f2, ld32(B2 + off), ld32(B2 + off + 8));
    }
  }
}

// Phase B: acc (64 x CS/2 per warp half) += Pm (64 x K, row-major bf16, row
// stride PST) times Vm (K x CS, row-major bf16, row stride VST). Warp w owns
// rows 16 (w % 4) .. +15 and channels (w / 4) CS / 2 .. of the slice.
template <int K, int PST, int VST, int CS>
__device__ __forceinline__ void phase_b(const __nv_bfloat16* Pm, const __nv_bfloat16* Vm,
                                        float (*acc)[4]) {
  constexpr int ONT = CS / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int strip = warp % 4, c0 = (warp / 4) * (CS / 2);
  const __nv_bfloat16* pa = Pm + (strip * 16 + g) * PST + 2 * tq;
  const int mat = lane >> 3, mi = lane & 7;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    a[0] = ld32(pa + kk);
    a[1] = ld32(pa + 8 * PST + kk);
    a[2] = ld32(pa + kk + 8);
    a[3] = ld32(pa + 8 * PST + kk + 8);
    const __nv_bfloat16* vrow = Vm + (kk + mi + (mat & 1) * 8) * VST + (mat >> 1) * 8 + c0;
#pragma unroll
    for (int j = 0; j < ONT; j += 2) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, vrow + j * 8);
      mma_bf16(acc[j], a, bfr[0], bfr[1]);
      mma_bf16(acc[j + 1], a, bfr[2], bfr[3]);
    }
  }
}

// Write a phase-B accumulator (64 x CS slice at channel cs0) as bf16 rows of
// a (rows, C) tensor starting at `out`.
template <int C, int CS>
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* out, int cs0,
                                               const float (*acc)[4]) {
  constexpr int ONT = CS / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int row = (warp % 4) * 16 + g, c0 = cs0 + (warp / 4) * (CS / 2) + 2 * tq;
#pragma unroll
  for (int j = 0; j < ONT; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + c0 + j * 8) =
        __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * C + c0 + j * 8) =
        __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <int C, int BQ>
struct DkdvCfg {
  static constexpr int BK = 64, CS = 128;
  static constexpr int ST = C + 8;   // padded row strides (elements): rows
  static constexpr int PST = BQ + 8; // shift by 4 banks, fragment loads conflict-free
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * ((2 * BK + 2 * BQ) * ST + 2 * BK * PST) +
      sizeof(float) * 2 * BQ;
};

template <int C, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int L, float scale) {
  using Cfg = DkdvCfg<C, BQ>;
  constexpr int BK = Cfg::BK, CS = Cfg::CS, ST = Cfg::ST, PST = Cfg::PST;
  constexpr int NT = BQ / 16, ONT = CS / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * ST;
  __nv_bfloat16* Qs = Vs + BK * ST;
  __nv_bfloat16* dOs = Qs + BQ * ST;
  __nv_bfloat16* Ps = dOs + BQ * ST;   // P^T  (BK x BQ)
  __nv_bfloat16* dSs = Ps + BK * PST;  // dS^T (BK x BQ)
  float* s_lse = reinterpret_cast<float*>(dSs + BK * PST);
  float* s_di = s_lse + BQ;

  const int b = blockIdx.y, k0 = blockIdx.x * BK, cs0 = blockIdx.z * CS;
  const size_t img = (size_t)b * L * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int strip = warp / 2, n0 = (warp % 2) * (BQ / 2);

  load_tile_bf16<C, ST>(Ks, k + img + (size_t)k0 * C, BK);
  load_tile_bf16<C, ST>(Vs, v + img + (size_t)k0 * C, BK);

  float acc_dv[ONT][4], acc_dk[ONT][4];
#pragma unroll
  for (int j = 0; j < ONT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) { acc_dv[j][e] = 0.f; acc_dk[j][e] = 0.f; }

  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();  // the previous tile's Q, dO, P, dS are no longer read
    load_tile_bf16<C, ST>(Qs, q + img + (size_t)q0 * C, BQ);
    load_tile_bf16<C, ST>(dOs, dout + img + (size_t)q0 * C, BQ);
    load_rows_f32(s_lse, lse + (size_t)b * L + q0, BQ);
    load_rows_f32(s_di, di + (size_t)b * L + q0, BQ);
    __syncthreads();

    // S^T = K Q^T * scale and dP^T = V dO^T, then P^T and dS^T
    {
      float s[NT][4], dp[NT][4];
      phase_a<C, ST, BQ>(Ks, Qs, Vs, dOs, s, dp);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8
          const int row = strip * 16 + g + 8 * h, col = n0 + j * 8 + 2 * tq;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = expf(s[j][2 * h + e] * scale - s_lse[col + e]);
            ds[e] = p[e] * (dp[j][2 * h + e] - s_di[col + e]) * scale;
          }
          *reinterpret_cast<__nv_bfloat162*>(Ps + row * PST + col) =
              __floats2bfloat162_rn(p[0], p[1]);
          *reinterpret_cast<__nv_bfloat162*>(dSs + row * PST + col) =
              __floats2bfloat162_rn(ds[0], ds[1]);
        }
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over this block's channel slice
    phase_b<BQ, PST, ST, CS>(Ps, dOs + cs0, acc_dv);
    phase_b<BQ, PST, ST, CS>(dSs, Qs + cs0, acc_dk);
  }
  store_acc_bf16<C, CS>(dk + img + (size_t)k0 * C, cs0, acc_dk);
  store_acc_bf16<C, CS>(dv + img + (size_t)k0 * C, cs0, acc_dv);
}

template <int C, int BK>
struct DqCfg {
  static constexpr int BQ = 64, CS = C < 256 ? C : 256;
  static constexpr int ST = C + 8;
  static constexpr int PST = BK + 8;
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * ((2 * BQ + 2 * BK) * ST + BQ * PST) + sizeof(float) * 2 * BQ;
};

template <int C, int BK>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        __nv_bfloat16* __restrict__ dq, int L, float scale) {
  using Cfg = DqCfg<C, BK>;
  constexpr int BQ = Cfg::BQ, CS = Cfg::CS, ST = Cfg::ST, PST = Cfg::PST;
  constexpr int NT = BK / 16, ONT = CS / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * ST;
  __nv_bfloat16* Ks = dOs + BQ * ST;
  __nv_bfloat16* Vs = Ks + BK * ST;
  __nv_bfloat16* dSs = Vs + BK * ST;  // dS (BQ x BK)
  float* s_lse = reinterpret_cast<float*>(dSs + BQ * PST);
  float* s_di = s_lse + BQ;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ, cs0 = blockIdx.z * CS;
  const size_t img = (size_t)b * L * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int strip = warp / 2, n0 = (warp % 2) * (BK / 2);

  load_tile_bf16<C, ST>(Qs, q + img + (size_t)q0 * C, BQ);
  load_tile_bf16<C, ST>(dOs, dout + img + (size_t)q0 * C, BQ);
  load_rows_f32(s_lse, lse + (size_t)b * L + q0, BQ);
  load_rows_f32(s_di, di + (size_t)b * L + q0, BQ);

  float acc[ONT][4];
#pragma unroll
  for (int j = 0; j < ONT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's K, V, dS are no longer read
    load_tile_bf16<C, ST>(Ks, k + img + (size_t)k0 * C, BK);
    load_tile_bf16<C, ST>(Vs, v + img + (size_t)k0 * C, BK);
    __syncthreads();

    // S = Q K^T * scale and dP = dO V^T, then dS
    {
      float s[NT][4], dp[NT][4];
      phase_a<C, ST, BK>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = strip * 16 + g + 8 * h;
        const float l_row = s_lse[row], d_row = s_di[row];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + j * 8 + 2 * tq;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(s[j][2 * h + e] * scale - l_row);
            ds[e] = p * (dp[j][2 * h + e] - d_row) * scale;
          }
          *reinterpret_cast<__nv_bfloat162*>(dSs + row * PST + col) =
              __floats2bfloat162_rn(ds[0], ds[1]);
        }
      }
    }
    __syncthreads();

    // dQ += dS K over this block's channel slice
    phase_b<BK, PST, ST, CS>(dSs, Ks + cs0, acc);
  }
  store_acc_bf16<C, CS>(dq + img + (size_t)q0 * C, cs0, acc);
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32CS = 128;  // output channels per block: lane * 4 .. + 3

// Phase A for fp32: X[r][n] = A1[r] . B1[n] * scale and Y[r][n] = A2[r] . B2[n]
// for an (RM x BN) tile; thread t owns column t % BN and rows t / BN + i *
// (256 / BN). A row-major (RM x C), B row-major (BN x C), stride ST.
template <int C, int ST, int RM, int BN>
__device__ __forceinline__ void phase_a_f32(const float* A1, const float* B1, const float* A2,
                                            const float* B2, float scale, float* x,
                                            float* y) {
  constexpr int NE = RM * BN / kThreads, RSTEP = kThreads / BN;
  const int col = threadIdx.x % BN, r0 = threadIdx.x / BN;
#pragma unroll
  for (int i = 0; i < NE; ++i) { x[i] = 0.f; y[i] = 0.f; }
  const float* b1 = B1 + col * ST;
  const float* b2 = B2 + col * ST;
#pragma unroll 2
  for (int d = 0; d < C; d += 4) {
    const float4 u1 = *reinterpret_cast<const float4*>(b1 + d);
    const float4 u2 = *reinterpret_cast<const float4*>(b2 + d);
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int r = r0 + i * RSTEP;
      const float4 a1 = *reinterpret_cast<const float4*>(A1 + r * ST + d);
      const float4 a2 = *reinterpret_cast<const float4*>(A2 + r * ST + d);
      x[i] += a1.x * u1.x + a1.y * u1.y + a1.z * u1.z + a1.w * u1.w;
      y[i] += a2.x * u2.x + a2.y * u2.y + a2.z * u2.z + a2.w * u2.w;
    }
  }
#pragma unroll
  for (int i = 0; i < NE; ++i) x[i] *= scale;
}

// Phase B for fp32: acc[r][e] += sum_k Pm[row_r][k] Vm[k][c0 + lane * 4 + e]
// over RM rows, warp w owning rows w * RM / 8 .. (RM / 8 rows each).
template <int K, int PST, int ST, int RM>
__device__ __forceinline__ void phase_b_f32(const float* Pm, const float* Vm,
                                            float (*acc)[4]) {
  constexpr int RW = RM / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float4 vv = *reinterpret_cast<const float4*>(Vm + kk * ST + lane * 4);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float p = Pm[(warp * RW + r) * PST + kk];
      acc[r][0] += p * vv.x;
      acc[r][1] += p * vv.y;
      acc[r][2] += p * vv.z;
      acc[r][3] += p * vv.w;
    }
  }
}

template <int C, int RM>
__device__ __forceinline__ void store_acc_f32(float* out, int cs0, const float (*acc)[4]) {
  constexpr int RW = RM / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < RW; ++r)
    *reinterpret_cast<float4*>(out + (size_t)(warp * RW + r) * C + cs0 + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

template <int C>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int rows) {
  constexpr int V = C / 4, ST = C + 4;
  for (int i = threadIdx.x; i < rows * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 4;
    *reinterpret_cast<float4*>(dst + r * ST + c) =
        *reinterpret_cast<const float4*>(src + (size_t)r * C + c);
  }
}

// Tile rows: the (BM rows kept for the whole block, BN rows streamed) pair.
template <int C> struct F32Tiles {
  static constexpr int KEEP = C > 256 ? 16 : 32, STREAM = 32;
  static constexpr int ST = C + 4, PST = STREAM + 1;
  static constexpr size_t smem_bytes =
      sizeof(float) * ((2 * KEEP + 2 * STREAM) * ST + 2 * KEEP * PST + 2 * STREAM);
};

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, int L,
                         float scale) {
  using T = F32Tiles<C>;
  constexpr int BK = T::KEEP, BQ = T::STREAM, ST = T::ST, PST = T::PST;
  constexpr int NE = BK * BQ / kThreads, RSTEP = kThreads / BQ, RW = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BK * ST;
  float* Qs = Vs + BK * ST;
  float* dOs = Qs + BQ * ST;
  float* Ps = dOs + BQ * ST;   // P^T  (BK x BQ)
  float* dSs = Ps + BK * PST;  // dS^T (BK x BQ)
  float* s_lse = dSs + BK * PST;
  float* s_di = s_lse + BQ;

  const int b = blockIdx.y, k0 = blockIdx.x * BK, cs0 = blockIdx.z * kF32CS;
  const size_t img = (size_t)b * L * C;
  load_tile_f32<C>(Ks, k + img + (size_t)k0 * C, BK);
  load_tile_f32<C>(Vs, v + img + (size_t)k0 * C, BK);
  float acc_dv[RW][4], acc_dk[RW][4];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) { acc_dv[r][e] = 0.f; acc_dk[r][e] = 0.f; }

  const int col = threadIdx.x % BQ, r0 = threadIdx.x / BQ;
  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();
    load_tile_f32<C>(Qs, q + img + (size_t)q0 * C, BQ);
    load_tile_f32<C>(dOs, dout + img + (size_t)q0 * C, BQ);
    load_rows_f32(s_lse, lse + (size_t)b * L + q0, BQ);
    load_rows_f32(s_di, di + (size_t)b * L + q0, BQ);
    __syncthreads();
    {
      float s[NE], dp[NE];
      phase_a_f32<C, ST, BK, BQ>(Ks, Qs, Vs, dOs, scale, s, dp);
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int row = r0 + i * RSTEP;
        const float p = expf(s[i] - s_lse[col]);
        Ps[row * PST + col] = p;
        dSs[row * PST + col] = p * (dp[i] - s_di[col]) * scale;
      }
    }
    __syncthreads();
    phase_b_f32<BQ, PST, ST, BK>(Ps, dOs + cs0, acc_dv);
    phase_b_f32<BQ, PST, ST, BK>(dSs, Qs + cs0, acc_dk);
  }
  store_acc_f32<C, BK>(dk + img + (size_t)k0 * C, cs0, acc_dk);
  store_acc_f32<C, BK>(dv + img + (size_t)k0 * C, cs0, acc_dv);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       float* __restrict__ dq, int L, float scale) {
  using T = F32Tiles<C>;
  constexpr int BQ = T::KEEP, BK = T::STREAM, ST = T::ST, PST = T::PST;
  constexpr int NE = BQ * BK / kThreads, RSTEP = kThreads / BK, RW = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BQ * ST;
  float* Ks = dOs + BQ * ST;
  float* Vs = Ks + BK * ST;
  float* dSs = Vs + BK * ST;  // dS (BQ x BK)
  float* s_lse = dSs + 2 * BQ * PST;
  float* s_di = s_lse + BK;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ, cs0 = blockIdx.z * kF32CS;
  const size_t img = (size_t)b * L * C;
  load_tile_f32<C>(Qs, q + img + (size_t)q0 * C, BQ);
  load_tile_f32<C>(dOs, dout + img + (size_t)q0 * C, BQ);
  load_rows_f32(s_lse, lse + (size_t)b * L + q0, BQ);
  load_rows_f32(s_di, di + (size_t)b * L + q0, BQ);
  float acc[RW][4];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  const int col = threadIdx.x % BK, r0 = threadIdx.x / BK;
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_tile_f32<C>(Ks, k + img + (size_t)k0 * C, BK);
    load_tile_f32<C>(Vs, v + img + (size_t)k0 * C, BK);
    __syncthreads();
    {
      float s[NE], dp[NE];
      phase_a_f32<C, ST, BQ, BK>(Qs, Ks, dOs, Vs, scale, s, dp);
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int row = r0 + i * RSTEP;
        const float p = expf(s[i] - s_lse[row]);
        dSs[row * PST + col] = p * (dp[i] - s_di[row]) * scale;
      }
    }
    __syncthreads();
    phase_b_f32<BK, PST, ST, BQ>(dSs, Ks + cs0, acc);
  }
  store_acc_f32<C, BQ>(dq + img + (size_t)q0 * C, cs0, acc);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int C>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* di, void* dq, void* dk, void* dv, int B, int L,
                float scale, cudaStream_t stream) {
  using Q = __nv_bfloat16;
  constexpr int BQ = C > 256 ? 32 : 64;  // dK/dV launch: q rows per step
  constexpr int BK = C > 256 ? 32 : 64;  // dQ launch: key rows per step
  using KV = DkdvCfg<C, BQ>;
  using DQ = DqCfg<C, BK>;
  static_assert(KV::smem_bytes <= 232448 && DQ::smem_bytes <= 232448, "shared memory");
  auto kv_kernel = attn_bwd_dkdv_bf16_kernel<C, BQ>;
  auto dq_kernel = attn_bwd_dq_bf16_kernel<C, BK>;
  cudaError_t err = allow_smem(kv_kernel, KV::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dq_kernel, DQ::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<dim3(L / KV::BK, B, C / KV::CS), kThreads, KV::smem_bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const Q*>(k), static_cast<const Q*>(v),
      static_cast<const Q*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<Q*>(dk), static_cast<Q*>(dv), L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3(L / DQ::BQ, B, C / DQ::CS), kThreads, DQ::smem_bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const Q*>(k), static_cast<const Q*>(v),
      static_cast<const Q*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<Q*>(dq), L, scale);
  return (int)cudaGetLastError();
}

template <int C>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, void* dq, void* dk, void* dv, int B, int L, float scale,
               cudaStream_t stream) {
  using T = F32Tiles<C>;
  static_assert(T::smem_bytes <= 232448, "shared memory");
  auto kv_kernel = attn_bwd_dkdv_f32_kernel<C>;
  auto dq_kernel = attn_bwd_dq_f32_kernel<C>;
  cudaError_t err = allow_smem(kv_kernel, T::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dq_kernel, T::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const float* f[6] = {static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(di)};
  kv_kernel<<<dim3(L / T::KEEP, B, C / kF32CS), kThreads, T::smem_bytes, stream>>>(
      f[0], f[1], f[2], f[3], f[4], f[5], static_cast<float*>(dk), static_cast<float*>(dv),
      L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3(L / T::KEEP, B, C / kF32CS), kThreads, T::smem_bytes, stream>>>(
      f[0], f[1], f[2], f[3], f[4], f[5], static_cast<float*>(dq), L, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: (B, L, C) contiguous, fp32 (dtype 0) or bf16
// (dtype 1); lse, di: (B, L) fp32. Takes C in {128, 256, 512} and L % 64 == 0
// (the Python wrapper checks and raises outside them). Returns
// cudaGetLastError().
int gdt_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* di, void* dq, void* dk, void* dv, int B,
                      int L, int C, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (C) {
      case 128: return launch_bf16<128>(q, k, v, dout, lse, di, dq, dk, dv, B, L, scale, s);
      case 256: return launch_bf16<256>(q, k, v, dout, lse, di, dq, dk, dv, B, L, scale, s);
      case 512: return launch_bf16<512>(q, k, v, dout, lse, di, dq, dk, dv, B, L, scale, s);
    }
  } else if (dtype == 0) {
    switch (C) {
      case 128: return launch_f32<128>(q, k, v, dout, lse, di, dq, dk, dv, B, L, scale, s);
      case 256: return launch_f32<256>(q, k, v, dout, lse, di, dq, dk, dv, B, L, scale, s);
      case 512: return launch_f32<512>(q, k, v, dout, lse, di, dq, dk, dv, B, L, scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
