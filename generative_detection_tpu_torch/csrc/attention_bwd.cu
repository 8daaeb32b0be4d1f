// Single-head attention backward over (B, L, C) tensors, for Hopper (sm_90a):
// dq, dk, dv of O = softmax(q k^T * scale) v from q, k, v, dO, the forward's
// row logsumexp `lse` and di = rowsum(dO * O), both (B, L) fp32.
//
// Replaces generative_detection_tpu/ops/attention.py `_mha_bwd_call` (kernel
// `_mha_bwd_kernel`). The TPU kernel runs one pass over q blocks with the
// whole (L, C) K and V of an image and two (L, C) fp32 dK/dV accumulators in
// VMEM (about 16 MiB at 4096 x 256). A Hopper block has 227 KB of shared
// memory and 64K registers, so the work is split into blocks that each own
// 64 rows of one output, all deterministic (no atomics; two calls give the
// same bits):
//
//   dK, dV: a block of 64 key rows walks all q tiles:
//       S^T  = K Q^T * scale,  P^T = exp(S^T - lse)            (fp32)
//       dV  += bf(P^T) dO                                      (fp32 acc)
//       dP^T = V dO^T,         dS^T = bf(P^T (dP^T - di) * scale)
//       dK  += dS^T Q                                          (fp32 acc)
//   dQ: a block of 64 query rows walks all key tiles: S, P, dP, dS as
//     above, dQ += dS K.
//
// bf() is the rounding of `_mha_bwd_kernel`: P is cast to dO's dtype before
// the dV product and dS to q's dtype before the dK and dQ products; every
// product accumulates in fp32 and dq, dk, dv are written in q's dtype.
//
// Bound on the H100: at (B, 4096, 256) the backward is compute-bound (five
// L x L x C products, 10 B L^2 C flops); at (B, 256, 512) memory-bound.
//
// Every kernel is warp-specialized on TMA and wgmma: a producer (one thread)
// streams tiles by TMA into a ring of 128-byte swizzled shared memory, paced
// by full/empty mbarriers, while consumer warpgroups run the products with
// the accumulators in registers; P^T and dS^T (or P and dS) go from the
// accumulator to the next product's A operand in registers (RS wgmma).
//
// bf16 at C = 64, 128, 256 (namespace wg: the flagship's L = 4096 sites at
// 256, the tiny configs' (B, 256, 64), every width 65..128 padded to 128):
//   attn_bwd_dkdv_wgmma_kernel<C>: a block owns 64 key rows (K, V resident)
//     and streams 64-row (Q, dO, lse, di) tiles through a two-stage ring.
//     Its two consumer warpgroups split the work by role, not by channel, so
//     nothing is recomputed: warpgroup A computes S^T (wgmma, operands in
//     shared memory), P^T in registers, hands the fp32 P^T to warpgroup B
//     through an 18 KB shared buffer, and adds bf(P^T) dO into dV (dO
//     MN-major through the transpose bit); warpgroup B computes dP^T, dS^T
//     and dK += dS^T Q. Each dK/dV accumulator (64 x C fp32) holds C / 2
//     registers a thread.
//   attn_bwd_dq_wgmma_kernel<C>: a block owns 64 query rows (Q, dO, lse, di
//     resident) and streams 64-row K and V tiles; one consumer warpgroup
//     computes S and dP, dS in registers, dQ += dS K.
// Together they run the four products of the dK/dV pass once each and S,
// dP, dQ in the dQ pass: 14 B L^2 C flops against the bound's 10. At C =
// 64 and 128 the grids of the checked sites have fewer blocks than SMs, so
// a block's latency decides and one block an SM (all registers) is kept.
//
// bf16 at C = 512 (the flagship's (B, 256, 512) mid-block sites; namespace
// wide): a 64 x 512 fp32 accumulator is 256 registers a thread and K, V,
// Q, dO tiles of 64 rows are 64 KB each, so neither the dK/dV pair of one
// block nor full-width tiles in a ring fit. attn_bwd_c512_wgmma_kernel: a
// block owns 64 rows and one 256-channel half of one role's output (dK, dQ
// or dV; blockIdx.z = 2 role + half, the heavier roles first) in one
// consumer warpgroup (128 registers a thread), and forms the role's S (and
// dP) over all 512 channels from 64 x 256 tiles. dK and dQ keep their R and
// X operands resident (K, V or Q, dO: 128 KB) and stream X's other operand
// and T (dO, Q or V, K) through a ring of three 32 KB tiles; dV keeps K and
// streams Q and its half of dO through a ring of five. Its 227 KB make it
// one block an SM, so a block's chains have the tensor cores alone: where
// the grid (6 B L / 64 blocks) fits one wave, a block's latency is the
// kernel's time. The launch forms S six times, dP four times and each
// output once: 26 B L^2 C flops against the bound's 10.
//
// fp32 at every C runs all five products on the tensor cores at
// fp32 accuracy (split precision, as the fp32 forward in attention.cu): a
// pre-pass writes three bf16 pieces of q, k, v and dO into scratch (each
// piece the round-to-nearest-even of what the earlier leave), and each
// product is the six piece products with i + j <= 2, accumulated in fp32; P
// and dS are split in registers into register A operands. The CUDA cores
// would bound it at 10 B L^2 C / 67 TFLOP/s; six bf16 piece products a
// product at 60 B L^2 C / 989 TFLOP/s, 2.4x lower. Shared memory decides
// the layout: one piece of a 64-row tile is 32 KB at C = 256, and 227 KB
// hold seven. The bf16 design's two resident operands (six tiles) and its
// P^T hand-over do not fit beside a ring, so each block holds one 64 x C
// fp32 accumulator in one consumer warpgroup (128 registers a thread at
// C = 256) and has one role (namespace sp):
//   dK: K_0 resident; streams V (its own rows), dO, Q and K_1, K_2: dP^T =
//     V dO^T, S^T = K Q^T, dS^T, dK += dS^T Q (Q kept in the ring from S^T);
//   dQ: the same with Q_0 resident, dO (its own rows), V, K and Q_1, Q_2:
//     dP, S, dS, dQ += dS K;
//   dV: K's three pieces resident; streams Q, dO: S^T, P^T, dV += P^T dO.
// dK and dQ multiply two streamed operands for dP: four tiles live at once,
// and two slots more (a ring of six, so only K_0 or Q_0 stays resident) let
// each tile load while the chain before it runs (three pieces resident and
// a ring of four left the consumer waiting on tiles for 15% of the kernel,
// tools/ablate_attention_split_bwd.py). The three roles share
// one launch (blockIdx.z) after the pre-pass: 48 piece-product units of
// 64 x 64 x C per pair of tiles against the 30 of one pass, the price of
// the 227 KB (S^T in both the dK and dV roles, S and dP again for dQ).
// At C = 512 (the (B, 256, 512) mid-block sites) a 64-row piece tile is 64
// KB and a 64 x 512 accumulator 256 registers, so a block owns half its
// role's output channels and streams 256-column piece tiles (see
// run_block_wide). Deterministic: no atomics, every sum in a fixed order.
//
// Lengths off the grid: the wrapper pads L to a multiple of 128 with zero
// rows (dO and di of a padded query row are 0, so it adds nothing to dK or
// dV) and passes the true length l_valid. Every kernel sets P = 0 for the
// keys at or past it (their logits are -inf), and the kernels that walk key
// tiles (dQ) walk only those that hold a key below l_valid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Rows 16 warp + g and + 8 of a (64, N) fp32 accumulator (as wgmma leaves
// it) as bf16 rows of `out` (row stride LD), from its column 2 tq.
template <int N, int LD>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* out, const float (&acc)[N / 2],
                                                int warp, int g, int tq) {
  __nv_bfloat16* r = out + (size_t)(warp * 16 + g) * LD + 2 * tq;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(r + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(r + 8 * LD + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 at C = 64, 128, 256: wgmma + TMA, warp-specialized (see the top of the file)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BR = 64, STAGES = 2;     // BR: rows of every tile
constexpr uint32_t ROW_STAT = BR * 4;  // 64 fp32 lse or di values
constexpr int PST = BR + 8;            // fp32 P^T row stride: float2 stores conflict-free

template <int C>
struct Cfg {
  static constexpr int CHUNKS = C / 64;           // 128-byte column chunks of a tile
  static constexpr uint32_t TILE = BR * C * 2;    // one (64, C) bf16 tile
  static constexpr size_t DKDV_SMEM = 1024 + 6 * TILE + 4 * ROW_STAT + BR * PST * 4 + 8 * 8;
  static constexpr size_t DQ_SMEM = 1024 + 6 * TILE + 2 * ROW_STAT + 8 * 8;
};

// One (64, C) tile by TMA: C / 64 boxes of (64, 64), one per column chunk.
template <int C>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row) {
#pragma unroll
  for (int ch = 0; ch < Cfg<C>::CHUNKS; ++ch)
    hopper::tma_load_2d(dst + ch * BR * 128, map, bar, ch * 64, row);
}

// acc (64 x C) += A (64 x 64 from registers) B, B a (64, C) tile in shared
// memory read MN-major: four K steps of 16 rows.
template <int C>
__device__ __forceinline__ void mma_rs_tile(float (&acc)[C / 2], uint32_t (&a)[BR / 16][4],
                                            uint32_t b_addr) {
  using namespace hopper;
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk)
    wgmma_rs_mn<C>(acc, a[kk], desc_mnmajor(b_addr + kk * 16 * 128, BR * 128));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// d (64 x 64) = A B^T with A, B (64, C) tiles in shared memory, both
// K-major (the contraction over the C channels); committed, not waited.
template <int C>
__device__ __forceinline__ void mma_ss_tile(float (&d)[BR / 2], uint32_t a_addr, uint32_t b_addr) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const uint32_t off = (kk / 4) * BR * 128 + (kk % 4) * 32;
    wgmma_ss_n64(d, desc_kmajor(a_addr + off), desc_kmajor(b_addr + off), 1);
  }
  wgmma_commit();
}

template <int C>
__global__ void __launch_bounds__(384, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int L, int l_valid, float scale) {
  using namespace hopper;
  constexpr uint32_t TILE = Cfg<C>::TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);
  unsigned char* vs = ks + TILE;
  unsigned char* qs = vs + TILE;         // [STAGES] tiles
  unsigned char* dos = qs + STAGES * TILE;  // [STAGES] tiles
  float* lse_s = reinterpret_cast<float*>(dos + STAGES * TILE);  // [STAGES][BR]
  float* di_s = lse_s + STAGES * BR;                             // [STAGES][BR]
  float* pbuf = di_s + STAGES * BR;                              // P^T, [BR][PST]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(pbuf + BR * PST);
  uint64_t* qd_full = kv_full + 1;
  uint64_t* qd_empty = qd_full + STAGES;
  uint64_t* p_full = qd_empty + STAGES;
  uint64_t* p_empty = p_full + 1;

  const int row0 = blockIdx.y * L, k0 = blockIdx.x * BR, n_tiles = L / BR;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&qd_full[s], 1);
      mbar_init(&qd_empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(p_full, 128);   // every thread of warpgroup A
    mbar_init(p_empty, 128);  // every thread of warpgroup B
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * TILE);
      load_tile<C>(ks, &tm_k, kv_full, row0 + k0);
      load_tile<C>(vs, &tm_v, kv_full, row0 + k0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, r = row0 + it * BR;
        mbar_wait(&qd_empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&qd_full[s], 2 * TILE + 2 * ROW_STAT);
        load_tile<C>(qs + s * TILE, &tm_q, &qd_full[s], r);
        load_tile<C>(dos + s * TILE, &tm_do, &qd_full[s], r);
        bulk_load(lse_s + s * BR, lse + r, ROW_STAT, &qd_full[s]);
        bulk_load(di_s + s * BR, di + r, ROW_STAT, &qd_full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();
  const bool role_a = threadIdx.x < 256;  // A: S^T, P^T, dV;  B: dP^T, dS^T, dK
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const float scale_log2 = scale * kLog2e;
  // this thread's accumulator rows (keys) and columns (queries 8 j + 2 tq, + 1)
  float* prow = pbuf + (warp * 16 + g) * PST + 2 * tq;

  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);
  const uint32_t kv_addr = smem_u32(role_a ? ks : vs);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t q_addr = smem_u32(qs + s * TILE), do_addr = smem_u32(dos + s * TILE);
    float sc[BR / 2];
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) sc[i] = 0.f;
    mbar_wait(&qd_full[s], (it / STAGES) & 1);
    fence_regs(sc);
    wgmma_fence();
    // A: S^T = K Q^T;  B: dP^T = V dO^T
    mma_ss_tile<C>(sc, kv_addr, role_a ? q_addr : do_addr);
    wgmma_wait<0>();
    fence_regs(sc);

    uint32_t a[BR / 16][4];
    if (role_a) {
      mask_keys<BR, false>(sc, k0, l_valid, warp, g, tq);  // rows: the block's keys
      const float* ls = lse_s + s * BR + 2 * tq;
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], scale_log2, -(e % 2 ? l2.y : l2.x) * kLog2e));
      }
      if (it > 0) mbar_wait(p_empty, (it - 1) & 1);  // B has read the previous P^T
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        *reinterpret_cast<float2*>(prow + 8 * j) = make_float2(sc[4 * j], sc[4 * j + 1]);
        *reinterpret_cast<float2*>(prow + 8 * PST + 8 * j) =
            make_float2(sc[4 * j + 2], sc[4 * j + 3]);
      }
      mbar_arrive(p_full);
      acc_to_a<BR / 8>(sc, a);  // bf(P^T)
      mma_rs_tile<C>(acc, a, do_addr);  // dV += P^T dO
    } else {
      const float* ds_ = di_s + s * BR + 2 * tq;
      mbar_wait(p_full, it & 1);
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(ds_ + 8 * j);
        const float2 p0 = *reinterpret_cast<const float2*>(prow + 8 * j);
        const float2 p1 = *reinterpret_cast<const float2*>(prow + 8 * PST + 8 * j);
        sc[4 * j] = p0.x * (sc[4 * j] - d2.x) * scale;
        sc[4 * j + 1] = p0.y * (sc[4 * j + 1] - d2.y) * scale;
        sc[4 * j + 2] = p1.x * (sc[4 * j + 2] - d2.x) * scale;
        sc[4 * j + 3] = p1.y * (sc[4 * j + 3] - d2.y) * scale;
      }
      mbar_arrive(p_empty);
      acc_to_a<BR / 8>(sc, a);  // bf(dS^T)
      mma_rs_tile<C>(acc, a, q_addr);  // dK += dS^T Q
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&qd_empty[s]);
  }
  store_rows_bf16<C, C>((role_a ? dv : dk) + (size_t)(row0 + k0) * C, acc, warp, g, tq);
}

template <int C>
__global__ void __launch_bounds__(256, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         __nv_bfloat16* __restrict__ dq, int L, int l_valid, float scale) {
  using namespace hopper;
  constexpr uint32_t TILE = Cfg<C>::TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* dos = qs + TILE;
  unsigned char* ks = dos + TILE;           // [STAGES] tiles
  unsigned char* vs = ks + STAGES * TILE;   // [STAGES] tiles
  float* lse_s = reinterpret_cast<float*>(vs + STAGES * TILE);
  float* di_s = lse_s + BR;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(di_s + BR);
  uint64_t* k_full = qd_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

  // the live key tiles
  const int row0 = blockIdx.y * L, q0 = blockIdx.x * BR, n_tiles = (l_valid + BR - 1) / BR;
  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * TILE + 2 * ROW_STAT);
      load_tile<C>(qs, &tm_q, qd_full, row0 + q0);
      load_tile<C>(dos, &tm_do, qd_full, row0 + q0);
      bulk_load(lse_s, lse + row0 + q0, ROW_STAT, qd_full);
      bulk_load(di_s, di + row0 + q0, ROW_STAT, qd_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, r = row0 + it * BR;
        mbar_wait(&kv_empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], TILE);
        load_tile<C>(ks + s * TILE, &tm_k, &k_full[s], r);
        mbar_expect_tx(&v_full[s], TILE);
        load_tile<C>(vs + s * TILE, &tm_v, &v_full[s], r);
      }
    }
    return;
  }
  // one consumer warpgroup: with 256 threads a block already has 255
  // registers a thread, so there is nothing to rebalance
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_u32(qs), do_addr = smem_u32(dos);

  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  mbar_wait(qd_full, 0);
  float l2[2], d2[2];  // rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l2[h] = lse_s[warp * 16 + g + 8 * h] * kLog2e;
    d2[h] = di_s[warp * 16 + g + 8 * h];
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const uint32_t k_addr = smem_u32(ks + s * TILE), v_addr = smem_u32(vs + s * TILE);
    float sc[BR / 2], dp[BR / 2];
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    // both tiles first: a wait between the two products would make the
    // compiler serialize the wgmmas
    mbar_wait(&k_full[s], ph);
    mbar_wait(&v_full[s], ph);
    wgmma_fence();
    mma_ss_tile<C>(sc, q_addr, k_addr);   // S = Q K^T
    mma_ss_tile<C>(dp, do_addr, v_addr);  // dP = dO V^T
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    mask_keys<BR, true>(sc, it * BR, l_valid, warp, g, tq);  // columns: the tile's keys
#pragma unroll
    for (int j = 0; j < BR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -l2[e / 2]));
        sc[4 * j + e] = p * (dp[4 * j + e] - d2[e / 2]) * scale;
      }
    uint32_t a[BR / 16][4];
    acc_to_a<BR / 8>(sc, a);  // bf(dS)
    mma_rs_tile<C>(acc, a, k_addr);  // dQ += dS K
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  }
  store_rows_bf16<C, C>(dq + (size_t)(row0 + q0) * C, acc, warp, g, tq);
}

template <int C>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* di, void* dq, void* dk, void* dv, int B, int L, int l_valid, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t rows = (uint64_t)B * L;
  int err = hopper::make_map_bf16(&tq, q, rows, C, BR);
  if (!err) err = hopper::make_map_bf16(&tk, k, rows, C, BR);
  if (!err) err = hopper::make_map_bf16(&tv, v, rows, C, BR);
  if (!err) err = hopper::make_map_bf16(&tdo, dout, rows, C, BR);
  if (err) return err;
  cudaError_t e = allow_smem(attn_bwd_dkdv_wgmma_kernel<C>, Cfg<C>::DKDV_SMEM);
  if (e == cudaSuccess) e = allow_smem(attn_bwd_dq_wgmma_kernel<C>, Cfg<C>::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  using Q = __nv_bfloat16;
  const float* f_lse = static_cast<const float*>(lse);
  const float* f_di = static_cast<const float*>(di);
  attn_bwd_dkdv_wgmma_kernel<C><<<dim3(L / BR, B), 384, Cfg<C>::DKDV_SMEM, stream>>>(
      tq, tk, tv, tdo, f_lse, f_di, static_cast<Q*>(dk), static_cast<Q*>(dv), L, l_valid,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq_wgmma_kernel<C><<<dim3(L / BR, B), 256, Cfg<C>::DQ_SMEM, stream>>>(
      tq, tk, tv, tdo, f_lse, f_di, static_cast<Q*>(dq), L, l_valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// fp32 at C = 64, 128, 256: split-precision wgmma (see the top of the file)
// ---------------------------------------------------------------------------

namespace sp {

constexpr int NP = 3;          // bf16 pieces of every fp32 operand
constexpr int BR = 64;         // rows of every tile
constexpr int TILES = 7;       // piece tiles in shared memory: resident, then the ring
constexpr int MAX_STAGES = 6;
constexpr int THREADS = 160;   // one consumer warpgroup and one producer warp
constexpr int STATS = 2 * BR;  // lse and di of one tile's rows, floats
constexpr int WIDE_C = 512, W = 256, CB = WIDE_C / W;  // C = 512: two 256-column blocks
// Steps (64 rows of the other side) whose products one wgmma accumulator
// chain sums at C <= 256. The tensor core's fp32 sum truncates, so a chain's
// error grows with its length: over 65536 rows dK missed 1e-3 of its RMS
// against float64 (2.3e-3; 1.6e-4 over 4096). Every FLUSH_TILES steps the
// accumulator is added into the output with IEEE fp32 arithmetic and
// restarts at zero; at most 4096 rows never flush.
constexpr int FLUSH_TILES = 64;

// The operands in scratch: piece p of row r of operand t at row (t NP + p) B L + r.
enum Operand { OPQ, OPK, OPV, OPDO };
// What a block accumulates over its 64 rows: dK, dQ or dV (blockIdx.z, the
// heavier roles first so that the lighter one fills the last wave).
enum Role { DK, DQ, DV };

template <int C>
struct Cfg {
  static constexpr uint32_t TILE = BR * C * 2;  // one piece of a 64-row tile
  // the tiles, two stats slots, 17 mbarriers
  static constexpr size_t SMEM =
      1024 + TILES * TILE + 2 * STATS * 4 + 8 * (1 + 2 * MAX_STAGES + 4);
  static_assert(SMEM <= 232448, "shared memory");
};

// The operands of a role. R: the block's own rows, S^T (dK, dV) or S (dQ)
// = R T^T with T at the step's rows. X = XA XB^T (dP^T for dK, dP for dQ):
// XA at the block's own rows, XB at the step's. At C <= 256 dV keeps R's
// three pieces resident (a ring of four), dK and dQ R_0 only (a ring of six).
template <int ROLE>
struct Ops {
  static constexpr int R = ROLE == DQ ? OPQ : OPK;
  static constexpr int T = ROLE == DQ ? OPK : OPQ;
  static constexpr int XA = ROLE == DQ ? OPDO : OPV;
  static constexpr int XB = ROLE == DQ ? OPV : OPDO;
  static constexpr int NRES = ROLE == DV ? NP : 1;      // resident pieces of R
  static constexpr int STAGES = TILES - NRES;           // ring slots
  static constexpr int ITEMS = ROLE == DV ? 2 * NP : 11;  // piece tiles a step
  static_assert(STAGES <= MAX_STAGES, "mbarriers");
};

// One (64, C) piece tile by TMA: C / 64 boxes of 64 x 64 from column col0.
template <int C>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int col0 = 0) {
#pragma unroll
  for (int ch = 0; ch < C / 64; ++ch)
    hopper::tma_load_2d(dst + ch * BR * 128, map, bar, col0 + ch * 64, row);
}

// d (64 x 64) (+)= A B^T over C channels, A and B piece tiles in shared
// memory (descriptors of their first byte), both K-major; issued, not
// committed. `first`: the tile's first product (scale-d 0). The descriptors
// pass through opaque() here, so the compiler derives each product's 2 C / 16
// from them where they are issued instead of computing every product's
// ahead of a chain (which spilled at C = 256).
template <int C>
__device__ __forceinline__ void mma_ss(float (&d)[BR / 2], uint64_t da, uint64_t db, bool first) {
  da = hopper::opaque(da);
  db = hopper::opaque(db);
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const uint32_t off = ((kk / 4) * BR * 128 + (kk % 4) * 32) >> 4;
    hopper::wgmma_ss<BR>(d, da + off, db + off, !(first && kk == 0));
  }
}

// The pre-pass: q, k, v, dout (blockIdx.y = the Operand) into NP bf16
// pieces each, out[(t * NP + p) * n + i] = piece p of element i of operand t.
__global__ void __launch_bounds__(256)
attn_bwd_split_operands_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               __nv_bfloat16* __restrict__ out, size_t n) {
  const int t = blockIdx.y;
  const float* x = t == OPQ ? q : t == OPK ? k : t == OPV ? v : dout;
  hopper::split_to_pieces<NP>(x, out + (size_t)t * NP * n, n);
}

// Step it's sc (S, rows 16 warp + g and + 8, columns 8 j + 2 tq and + 1 of
// the 64 x 64 tile) into P = exp(S scale - lse), and for dK and dQ on into
// dS = P (X - di) scale. stats: the lse of the tile's queries, their di BR
// floats on (dQ: its own rows, resident; dK and dV: the step's, in the slot
// st_full / st_empty of step it). The keys (dQ: the step's columns, dK and
// dV: the block's rows) at or past l_valid get P = 0 (their logit is -inf).
template <int ROLE>
__device__ __forceinline__ void softmax_grad(float (&sc)[BR / 2], const float (&xp)[BR / 2],
                                             const float* stats, uint64_t* st_full,
                                             uint64_t* st_empty, int it, int l_valid,
                                             float scale, int warp, int lane) {
  using namespace hopper;
  const int g = lane >> 2, tq = lane & 3;
  const float scale_log2 = scale * kLog2e;
  mask_keys<BR, ROLE == DQ>(sc, ROLE == DQ ? it * BR : blockIdx.x * BR, l_valid, warp, g, tq);
  if constexpr (ROLE == DQ) {
    // rows 16 warp + g and + 8 are queries: their lse and di, read from
    // shared memory each step rather than held in registers
    const float* ls = stats + warp * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l = ls[8 * h] * kLog2e, d = ls[BR + 8 * h];
#pragma unroll
      for (int j = 0; j < BR / 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -l));
          sc[4 * j + e] = p * (xp[4 * j + e] - d) * scale;
        }
    }
  } else {
    // columns 8 j + 2 tq and + 1 are queries: their lse and di
    const int st = it % 2;
    mbar_wait(&st_full[st], (it / 2) & 1);
    const float* ls = stats + st * STATS + 2 * tq;
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j);
      const float2 d2 = *reinterpret_cast<const float2*>(ls + BR + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -(e % 2 ? l2.y : l2.x) * kLog2e));
        if constexpr (ROLE == DV) {
          sc[4 * j + e] = p;
        } else {
          sc[4 * j + e] = p * (xp[4 * j + e] - (e % 2 ? d2.y : d2.x)) * scale;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&st_empty[st]);
  }
}

// A (64, C) fp32 accumulator (rows 16 warp + g and + 8, as wgmma leaves
// it) into the rows of `orow`'s tensor (row stride ld floats).
template <int C>
__device__ __forceinline__ void store_acc(float* orow, const float (&acc)[C / 2], int ld) {
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(orow + 8 * ld + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// store_acc, or with `add` the accumulator added to what the rows hold
// (IEEE fp32); then the accumulator is zero.
template <int C>
__device__ __forceinline__ void flush_acc(float* orow, float (&acc)[C / 2], int ld, bool add) {
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* dst = reinterpret_cast<float2*>(orow + 8 * h * ld + 8 * j);
      const float2 old = add ? *dst : make_float2(0.f, 0.f);
      *dst = make_float2(old.x + acc[4 * j + 2 * h], old.y + acc[4 * j + 2 * h + 1]);
      acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.f;
    }
}

// One block of a role: 64 rows, a consumer warpgroup (threads 0-127) and a
// producer warp (128-159) whose thread 128 issues every copy.
//
// Each step of 64 rows of the other side (query rows for dK and dV, key rows
// for dQ) the consumer runs wgmma chains, each drained before its slots go
// back and before any control flow. Each product's six piece products run
// smallest first: the tensor core's fp32 accumulation rounds each step to
// the accumulator's size, so the pieces below 2^-8 are summed before the
// leading product makes it large. Ring order and chains:
//   dK, dQ: XA2 XB2 XA0 XB0, chain X = (2,0) (0,2), frees XA2 XB2; XA1 XB1,
//     chain X += (1,1) (1,0) (0,1) (0,0), frees the four (a product of two
//     streamed operands: never more than four tiles live); T2, chain S =
//     (0,2); R1 T1, S += (1,1) (0,1); R2 T0, S += (2,0) (1,0) (0,0), frees
//     R1 R2. Every tile is freed before the tile six later needs its slot,
//     so the ring cannot deadlock, and each loads during an earlier chain;
//   dV: T2 T1 T0, S = R_i T_j as each lands (freed after it), dO2 dO1 dO0;
//   P = exp(S scale - lse); dK, dQ: dS = P (X - di) scale; split into three
//     pieces as register A operands;
//   dV: acc += sum of P_i dO_j; dK, dQ: acc += sum of dS_i T_j, T kept in
//     the ring from S and read MN-major where S read it K-major.
// dQ walks only the key tiles below l_valid; dK and dV every query tile (a
// padded query row has dO = 0 and di = 0, so it adds nothing).
template <int C, int ROLE>
__device__ __forceinline__ void run_block(const CUtensorMap* tm, const float* __restrict__ lse,
                                          const float* __restrict__ di, float* __restrict__ out,
                                          int L, int BL, int l_valid, float scale) {
  using namespace hopper;
  using O = Ops<ROLE>;
  constexpr uint32_t TILE = Cfg<C>::TILE;
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = O::STAGES;
  unsigned char* res = align_1024(smem_raw);  // [NRES][C / 64][BR][64]
  unsigned char* ring = res + O::NRES * TILE;  // [STAGES][C / 64][BR][64]
  float* stats = reinterpret_cast<float*>(res + TILES * TILE);  // [2][lse BR, di BR]
  uint64_t* res_full = reinterpret_cast<uint64_t*>(stats + 2 * STATS);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* st_full = empty + MAX_STAGES;
  uint64_t* st_empty = st_full + 2;

  const int row0 = blockIdx.y * L, rb = row0 + blockIdx.x * BR;
  const int n_tiles = ROLE == DQ ? (l_valid + BR - 1) / BR : L / BR;
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&st_full[s], 1);
      mbar_init(&st_empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: the resident pieces (with dQ's own lse and di), then
    // each step's stats (dK, dV) and piece tiles in the order they are taken
    if (threadIdx.x == 128) {
      mbar_expect_tx(res_full, O::NRES * TILE + (ROLE == DQ ? STATS * 4 : 0));
      for (int p = 0; p < O::NRES; ++p)
        load_tile<C>(res + p * TILE, tm, res_full, (O::R * NP + p) * BL + rb);
      if (ROLE == DQ) {
        bulk_load(stats, lse + rb, BR * 4, res_full);
        bulk_load(stats + BR, di + rb, BR * 4, res_full);
      }
      int n = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int ro = row0 + it * BR;
        if (ROLE != DQ) {
          const int st = it % 2;
          mbar_wait(&st_empty[st], ((it / 2) & 1) ^ 1);
          mbar_expect_tx(&st_full[st], STATS * 4);
          bulk_load(stats + st * STATS, lse + ro, BR * 4, &st_full[st]);
          bulk_load(stats + st * STATS + BR, di + ro, BR * 4, &st_full[st]);
        }
        for (int k = 0; k < O::ITEMS; ++k, ++n) {
          // (operand, piece, row) of the step's k-th tile
          int op = k < NP ? OPQ : OPDO, p = NP - 1 - k % NP, r = ro;  // dV
          if (ROLE != DV && k < 2 * NP) {  // XA2 XB2 XA0 XB0 XA1 XB1
            op = k % 2 ? O::XB : O::XA, p = k < 2 ? 2 : k < 4 ? 0 : 1, r = k % 2 ? ro : rb;
          } else if (ROLE != DV) {  // T2 R1 T1 R2 T0
            op = k % 2 ? O::R : O::T, p = k % 2 ? (k - 5) / 2 : (10 - k) / 2, r = k % 2 ? rb : ro;
          }
          const int s = n % STAGES;
          mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], TILE);
          load_tile<C>(ring + s * TILE, tm, &full[s], (op * NP + p) * BL + r);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  float* orow = out + (size_t)(rb + warp * 16 + g) * C + 2 * tq;
  mbar_wait(res_full, 0);

  int n = 0;  // piece tiles taken from the ring
  for (int it = 0; it < n_tiles; ++it) {
    if (it % FLUSH_TILES == 0 && it > 0) flush_acc<C>(orow, acc, C, it > FLUSH_TILES);
    // descriptors rebuilt each step from an opaque base, so the compiler
    // cannot keep every piece's descriptor live in registers
    const uint64_t dres = desc_kmajor(opaque(smem_u32(res)));
    const uint64_t dring = desc_kmajor(opaque(smem_u32(ring)));
    const uint64_t dring_mn = desc_mnmajor(opaque(smem_u32(ring)), BR * 128);
    auto slot = [&](int item) { return dring + ((item % STAGES) * TILE >> 4); };

    float xp[BR / 2];  // dP^T (dK) or dP (dQ)
    if constexpr (ROLE != DV) {
      // items n .. n + 5: XA2 XB2 XA0 XB0 XA1 XB1
#pragma unroll
      for (int i = 0; i < 4; ++i) mbar_wait(&full[(n + i) % STAGES], ((n + i) / STAGES) & 1);
      wgmma_fence();
      mma_ss<C>(xp, slot(n), slot(n + 3), true);       // (2, 0)
      mma_ss<C>(xp, slot(n + 2), slot(n + 1), false);  // (0, 2)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xp);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[n % STAGES]);
        mbar_arrive(&empty[(n + 1) % STAGES]);
      }
#pragma unroll
      for (int i = 4; i < 6; ++i) mbar_wait(&full[(n + i) % STAGES], ((n + i) / STAGES) & 1);
      fence_regs(xp);
      wgmma_fence();
      mma_ss<C>(xp, slot(n + 4), slot(n + 5), false);  // (1, 1)
      mma_ss<C>(xp, slot(n + 4), slot(n + 3), false);  // (1, 0)
      mma_ss<C>(xp, slot(n + 2), slot(n + 5), false);  // (0, 1)
      mma_ss<C>(xp, slot(n + 2), slot(n + 3), false);  // (0, 0)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xp);
      __syncwarp();
      if (lane == 0)
        for (int i = 2; i < 6; ++i) mbar_arrive(&empty[(n + i) % STAGES]);
      n += 2 * NP;
    }

    // S = sum of R_i T_j^T
    float sc[BR / 2];
    if constexpr (ROLE == DV) {
      // item n + q holds T_{2-q}, paired with the resident R_i, i = q .. 0
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int s = (n + q) % STAGES;
        mbar_wait(&full[s], ((n + q) / STAGES) & 1);
        if (q) fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int i = q; i >= 0; --i) mma_ss<C>(sc, dres + (i * TILE >> 4), slot(n + q), q == 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    } else {
      // items n .. n + 4: T2 R1 T1 R2 T0; R_0 is resident
      mbar_wait(&full[n % STAGES], (n / STAGES) & 1);
      wgmma_fence();
      mma_ss<C>(sc, dres, slot(n), true);  // (0, 2)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
#pragma unroll
      for (int i = 1; i < 3; ++i) mbar_wait(&full[(n + i) % STAGES], ((n + i) / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
      mma_ss<C>(sc, slot(n + 1), slot(n + 2), false);  // (1, 1)
      mma_ss<C>(sc, dres, slot(n + 2), false);         // (0, 1)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
#pragma unroll
      for (int i = 3; i < 5; ++i) mbar_wait(&full[(n + i) % STAGES], ((n + i) / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
      mma_ss<C>(sc, slot(n + 3), slot(n + 4), false);  // (2, 0)
      mma_ss<C>(sc, slot(n + 1), slot(n + 4), false);  // (1, 0)
      mma_ss<C>(sc, dres, slot(n + 4), false);         // (0, 0)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[(n + 1) % STAGES]);
        mbar_arrive(&empty[(n + 3) % STAGES]);
      }
    }
    const int t0 = n;  // the item of T_2 (dK, dQ: T_1 and T_0 at t0 + 2, t0 + 4)
    n += ROLE == DV ? NP : 5;

    // P = exp(S scale - lse); dK and dQ: dS = P (X - di) scale
    softmax_grad<ROLE>(sc, ROLE == DV ? sc : xp, stats, st_full, st_empty, it, l_valid, scale,
                       warp, lane);
    uint32_t pa[NP][BR / 16][4];
    acc_to_a_pieces<BR / 8, NP>(sc, pa);

    // acc += sum over i + j <= 2 of A_i U_j: A = P^T (dV) or dS (dK, dQ)
    // from registers, U = dO (dV, streamed now, U_{2-q} at n + q) or T (dK,
    // dQ, in the ring, T_{2-q} at t0 + 2 q)
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int item = ROLE == DV ? n + q : t0 + 2 * q, s = item % STAGES;
      if (ROLE == DV) mbar_wait(&full[s], (item / STAGES) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
        for (int i = q; i >= 0; --i)
          wgmma_rs_mn<C>(acc, pa[i][kk], dring_mn + ((s * TILE + kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (ROLE == DV) n += NP;
  }
  flush_acc<C>(orow, acc, C, n_tiles > FLUSH_TILES);
}

// tm: the (4 NP B L, C) bf16 map over the pieces, boxes of 64 columns x 64
// rows. dq, dk, dv: (B L, C) fp32. blockIdx.z: the Role.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_split_wgmma_kernel(const __grid_constant__ CUtensorMap tm, const float* __restrict__ lse,
                            const float* __restrict__ di, float* __restrict__ dq,
                            float* __restrict__ dk, float* __restrict__ dv, int L, int BL,
                            int l_valid, float scale) {
  if (blockIdx.z == DK) {
    run_block<C, DK>(&tm, lse, di, dk, L, BL, l_valid, scale);
  } else if (blockIdx.z == DQ) {
    run_block<C, DQ>(&tm, lse, di, dq, L, BL, l_valid, scale);
  } else {
    run_block<C, DV>(&tm, lse, di, dv, L, BL, l_valid, scale);
  }
}

// ---- C = 512 ---------------------------------------------------------------
//
// A 64-row piece tile is 64 KB at C = 512 and a 64 x 512 fp32 accumulator
// 256 registers a thread: no role can keep a full-width operand resident or
// own every output channel. So a block owns 64 rows and one half of its
// role's output channels (W = 256: 128 registers, as at C = 256; blockIdx.z
// = 2 role + half), and every piece tile is 64 rows x 256 columns (32 KB,
// one column block; the two blocks of a 512-wide row are two tiles). S and
// X are contractions over all 512 channels, each into one accumulator (a
// second one beside the output's spilled). The small piece products of both
// column blocks go in before either leading (0, 0) product, as the C = 256
// order needs: the first block's (0, 0) comes last, from its 0-pieces
// streamed a second time (a ring slot cannot hold them across the second
// block). R_0's two column blocks stay resident (64 KB); the other tiles
// stream through a ring of five, per step (c: the other half first, the
// block's own last; ' its 0-pieces again):
//   dK, dQ: X: XA2 XB2 XA0 XB0 XA1 XB1 of each c, chains as at C <= 256
//     (the first c without (0, 0)), then XA0' XB0', X += (0, 0);
//   S: R1 T2 T1 T0 R2 of each c: S += (0,2) | (1,1) (0,1) | (1,0), frees R1
//     | (2,0) and the last c's (0,0), frees R2 and the first c's T; then
//     T0', S += the first c's (0, 0). The last c's T pieces (the block's
//     half of T) stay: dK, dQ: acc += sum of dS_i T_j reads them MN-major;
//   dV: S as above, freeing every tile; then dO2 dO1 dO0 of the block's
//     half: acc += sum of P_i dO_j.
// No more than four streamed tiles are live at once, and every tile is freed
// before the tile five later needs its slot, so the ring cannot deadlock.
// The price of the halves: S and X are formed twice, 78 piece-product units
// of 64 x 64 x 512 per pair of tiles against the 30 of one pass. Streaming
// the 0-pieces twice costs 3 of a step's 25 tiles and 4% of the kernel's
// time; without it for X the peaked-softmax error reaches 1.01e-3 of the
// RMS against the plain version (tools/ablate_attention_split512_bwd.py).
template <int ROLE>
__device__ __forceinline__ void run_block_wide(const CUtensorMap* tm,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ di,
                                               float* __restrict__ out, int L, int BL,
                                               int l_valid, float scale) {
  using namespace hopper;
  using O = Ops<ROLE>;
  constexpr uint32_t TILE = Cfg<W>::TILE;
  constexpr int STAGES = TILES - CB;
  // piece tiles a step: X's 6 a column block and the first one's 0-pieces
  // again (dK, dQ), S's 5 a column block and T0 again, dO's 3 (dV)
  constexpr int X_ITEMS = ROLE == DV ? 0 : 6 * CB + 2;
  constexpr int S_ITEMS = 5 * CB + 1, ITEMS = X_ITEMS + S_ITEMS + (ROLE == DV ? NP : 0);
  static_assert(STAGES <= MAX_STAGES, "mbarriers");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = align_1024(smem_raw);  // R_0: [CB][W / 64][BR][64]
  unsigned char* ring = res + CB * TILE;      // [STAGES][W / 64][BR][64]
  float* stats = reinterpret_cast<float*>(res + TILES * TILE);  // [2][lse BR, di BR]
  uint64_t* res_full = reinterpret_cast<uint64_t*>(stats + 2 * STATS);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* st_full = empty + MAX_STAGES;
  uint64_t* st_empty = st_full + 2;

  const int half = blockIdx.z % CB;  // the output channels half W .. + W - 1
  const int row0 = blockIdx.y * L, rb = row0 + blockIdx.x * BR;
  const int n_tiles = ROLE == DQ ? (l_valid + BR - 1) / BR : L / BR;
  // the column block of the ci-th pass: the block's own half last
  auto cblock = [half](int ci) { return (half + 1 + ci) % CB; };
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&st_full[s], 1);
      mbar_init(&st_empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer
    if (threadIdx.x == 128) {
      mbar_expect_tx(res_full, CB * TILE + (ROLE == DQ ? STATS * 4 : 0));
      for (int c = 0; c < CB; ++c)
        load_tile<W>(res + c * TILE, tm, res_full, O::R * NP * BL + rb, c * W);
      if (ROLE == DQ) {
        bulk_load(stats, lse + rb, BR * 4, res_full);
        bulk_load(stats + BR, di + rb, BR * 4, res_full);
      }
      int n = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int ro = row0 + it * BR;
        if (ROLE != DQ) {
          const int st = it % 2;
          mbar_wait(&st_empty[st], ((it / 2) & 1) ^ 1);
          mbar_expect_tx(&st_full[st], STATS * 4);
          bulk_load(stats + st * STATS, lse + ro, BR * 4, &st_full[st]);
          bulk_load(stats + st * STATS + BR, di + ro, BR * 4, &st_full[st]);
        }
        for (int k = 0; k < ITEMS; ++k, ++n) {
          // (operand, piece, row, column block) of the step's k-th tile
          int op, p, r, c = cblock(0);
          if (k < 6 * CB && ROLE != DV) {  // XA2 XB2 XA0 XB0 XA1 XB1 of each column block
            const int j = k % 6;
            op = j % 2 ? O::XB : O::XA, p = j < 2 ? 2 : j < 4 ? 0 : 1, r = j % 2 ? ro : rb;
            c = cblock(k / 6);
          } else if (k < X_ITEMS) {  // XA0' XB0'
            op = k % 2 ? O::XB : O::XA, p = 0, r = k % 2 ? ro : rb;
          } else if (k < X_ITEMS + 5 * CB) {  // R1 T2 T1 T0 R2 of each column block
            const int j = (k - X_ITEMS) % 5;
            const bool is_r = j == 0 || j == 4;
            op = is_r ? O::R : O::T, p = j == 0 ? 1 : j == 4 ? 2 : 3 - j, r = is_r ? rb : ro;
            c = cblock((k - X_ITEMS) / 5);
          } else if (k < X_ITEMS + S_ITEMS) {  // T0'
            op = O::T, p = 0, r = ro;
          } else {  // dV: dO2 dO1 dO0 of the block's half
            op = OPDO, p = NP - 1 - (k - X_ITEMS - S_ITEMS), r = ro, c = half;
          }
          const int s = n % STAGES;
          mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], TILE);
          load_tile<W>(ring + s * TILE, tm, &full[s], (op * NP + p) * BL + r, c * W);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  mbar_wait(res_full, 0);

  int n = 0;  // piece tiles taken from the ring
  for (int it = 0; it < n_tiles; ++it) {
    const uint64_t dres = desc_kmajor(opaque(smem_u32(res)));
    const uint64_t dring = desc_kmajor(opaque(smem_u32(ring)));
    const uint64_t dring_mn = desc_mnmajor(opaque(smem_u32(ring)), BR * 128);
    auto slot = [&](int item) { return dring + ((item % STAGES) * TILE >> 4); };
    auto wait = [&](int item) { mbar_wait(&full[item % STAGES], (item / STAGES) & 1); };
    auto free_slot = [&](int item) { mbar_arrive(&empty[item % STAGES]); };

    float xp[BR / 2];  // dP^T (dK) or dP (dQ)
    if constexpr (ROLE != DV) {
#pragma unroll
      for (int ci = 0; ci < CB; ++ci) {
        // items n .. n + 5: XA2 XB2 XA0 XB0 XA1 XB1
#pragma unroll
        for (int i = 0; i < 4; ++i) wait(n + i);
        if (ci) fence_regs(xp);
        wgmma_fence();
        mma_ss<W>(xp, slot(n), slot(n + 3), ci == 0);   // (2, 0)
        mma_ss<W>(xp, slot(n + 2), slot(n + 1), false);  // (0, 2)
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(xp);
        __syncwarp();
        if (lane == 0) {
          free_slot(n);
          free_slot(n + 1);
        }
        wait(n + 4);
        wait(n + 5);
        fence_regs(xp);
        wgmma_fence();
        mma_ss<W>(xp, slot(n + 4), slot(n + 5), false);  // (1, 1)
        mma_ss<W>(xp, slot(n + 4), slot(n + 3), false);  // (1, 0)
        mma_ss<W>(xp, slot(n + 2), slot(n + 5), false);  // (0, 1)
        if (ci == CB - 1) mma_ss<W>(xp, slot(n + 2), slot(n + 3), false);  // (0, 0)
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(xp);
        __syncwarp();
        if (lane == 0)
          for (int i = 2; i < 6; ++i) free_slot(n + i);
        n += 6;
      }
      // items n, n + 1: XA0' XB0', the first column block's (0, 0)
      wait(n);
      wait(n + 1);
      fence_regs(xp);
      wgmma_fence();
      mma_ss<W>(xp, slot(n), slot(n + 1), false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xp);
      __syncwarp();
      if (lane == 0) {
        free_slot(n);
        free_slot(n + 1);
      }
      n += 2;
    }

    // S = sum of R_i T_j^T, each column block's items R1 T2 T1 T0 R2
    float sc[BR / 2];
    int t0 = 0;  // the item of the last block's T_2 (T_1, T_0 at t0 + 1, t0 + 2)
#pragma unroll
    for (int ci = 0; ci < CB; ++ci) {
      const uint64_t r0 = dres + ((cblock(ci) * TILE) >> 4);
      const bool last = ci == CB - 1;
      wait(n + 1);
      if (ci) fence_regs(sc);
      wgmma_fence();
      mma_ss<W>(sc, r0, slot(n + 1), ci == 0);  // (0, 2)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      wait(n);
      wait(n + 2);
      fence_regs(sc);
      wgmma_fence();
      mma_ss<W>(sc, slot(n), slot(n + 2), false);  // (1, 1)
      mma_ss<W>(sc, r0, slot(n + 2), false);       // (0, 1)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      wait(n + 3);
      fence_regs(sc);
      wgmma_fence();
      mma_ss<W>(sc, slot(n), slot(n + 3), false);  // (1, 0)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) free_slot(n);  // R1
      wait(n + 4);
      fence_regs(sc);
      wgmma_fence();
      mma_ss<W>(sc, slot(n + 4), slot(n + 3), false);      // (2, 0)
      if (last) mma_ss<W>(sc, r0, slot(n + 3), false);    // (0, 0)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) {
        free_slot(n + 4);  // R2
        if (ROLE == DV || !last)  // T stays only for dK's and dQ's own half
          for (int i = 1; i < 4; ++i) free_slot(n + i);
      }
      if (last) t0 = n + 1;
      n += 5;
    }
    // item n: T0', the first column block's (0, 0)
    wait(n);
    fence_regs(sc);
    wgmma_fence();
    mma_ss<W>(sc, dres + ((cblock(0) * TILE) >> 4), slot(n), false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) free_slot(n);
    n += 1;

    // P = exp(S scale - lse); dK and dQ: dS = P (X - di) scale
    softmax_grad<ROLE>(sc, ROLE == DV ? sc : xp, stats, st_full, st_empty, it, l_valid, scale,
                       warp, lane);
    uint32_t pa[NP][BR / 16][4];
    acc_to_a_pieces<BR / 8, NP>(sc, pa);

    // acc += sum over i + j <= 2 of A_i U_j over the block's half: U = dO
    // (dV, streamed now, U_{2-q} at n + q) or T (dK, dQ, in the ring, T_{2-q}
    // at t0 + q)
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int item = ROLE == DV ? n + q : t0 + q, s = item % STAGES;
      if (ROLE == DV) wait(item);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
        for (int i = q; i >= 0; --i)
          wgmma_rs_mn<W>(acc, pa[i][kk], dring_mn + ((s * TILE + kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (ROLE == DV) n += NP;
  }
  store_acc<W>(out + (size_t)(rb + warp * 16 + g) * WIDE_C + half * W + 2 * tq, acc, WIDE_C);
}

// As attn_bwd_split_wgmma_kernel at C = 512: blockIdx.z = 2 Role + half.
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_split512_wgmma_kernel(const __grid_constant__ CUtensorMap tm,
                               const float* __restrict__ lse, const float* __restrict__ di,
                               float* __restrict__ dq, float* __restrict__ dk,
                               float* __restrict__ dv, int L, int BL, int l_valid, float scale) {
  const int role = blockIdx.z / CB;
  if (role == DK) {
    run_block_wide<DK>(&tm, lse, di, dk, L, BL, l_valid, scale);
  } else if (role == DQ) {
    run_block_wide<DQ>(&tm, lse, di, dq, L, BL, l_valid, scale);
  } else {
    run_block_wide<DV>(&tm, lse, di, dv, L, BL, l_valid, scale);
  }
}

// scratch: 4 NP B L C bf16 (the pieces of q, k, v, dout).
template <int C>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* di, void* dq, void* dk, void* dv, void* scratch, int B, int L,
           int l_valid, float scale, cudaStream_t stream) {
  constexpr bool WIDE = C == WIDE_C;
  constexpr size_t SMEM = Cfg<WIDE ? W : C>::SMEM;
  const size_t n = (size_t)B * L * C;
  __nv_bfloat16* pieces = static_cast<__nv_bfloat16*>(scratch);
  const int blocks = (int)std::min<size_t>((n / 8 + 255) / 256, 132 * 8);
  attn_bwd_split_operands_kernel<<<dim3(blocks, 4), 256, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), pieces, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tm;
  const int err = hopper::make_map_bf16(&tm, pieces, (uint64_t)4 * NP * B * L, C, BR);
  if (err) return err;
  auto go = [&](auto kernel, int grid_z) {
    cudaError_t e = allow_smem(kernel, SMEM);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(L / BR, B, grid_z), THREADS, SMEM, stream>>>(
        tm, static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), L, B * L,
        l_valid, scale);
    return (int)cudaGetLastError();
  };
  if constexpr (WIDE) {
    return go(attn_bwd_split512_wgmma_kernel, 3 * CB);
  } else {
    return go(attn_bwd_split_wgmma_kernel<C>, 3);
  }
}

}  // namespace sp

// ---------------------------------------------------------------------------
// bf16 at C = 512: wgmma + TMA, a block per 64 rows of one role's output
// and one channel half (see the top of the file)
// ---------------------------------------------------------------------------

namespace wide {

using sp::BR;
using sp::STATS;
constexpr int C = 512, W = 256, CB = C / W;  // two 256-column blocks
constexpr uint32_t TILE = BR * W * 2;        // 64 rows of one column block, 32 KB
constexpr int TILES = 7;                     // tiles in shared memory: resident, then the ring
constexpr int MAX_STAGES = TILES - CB;       // dV's ring
// the tiles, two stats slots, 15 mbarriers
constexpr size_t SMEM = 1024 + TILES * TILE + 2 * STATS * 4 + 8 * (1 + 2 * MAX_STAGES + 4);
static_assert(SMEM <= 232448, "shared memory");

// R and XA resident (the block's own rows: R's two column blocks, then XA's
// for dK and dQ), the ring after them; stats and mbarriers after the tiles.
template <int ROLE>
struct Ops {
  static constexpr bool DV = ROLE == sp::DV;
  static constexpr int NRES = DV ? CB : 2 * CB;
  static constexpr int STAGES = TILES - NRES;  // 5 (dV) or 3 (dK, dQ)
  // ring items a step: dK, dQ: XB_0 XB_1 T_0 T_1; dV: T_0 T_1, then dO's
  // the block's own half U_h
  static constexpr int ITEMS = DV ? CB + 1 : 2 * CB;
};

struct Bars {
  uint64_t *res_full, *full, *empty, *st_full, *st_empty;
  __device__ explicit Bars(unsigned char* res)
      : res_full(reinterpret_cast<uint64_t*>(res + TILES * TILE + 2 * STATS * 4)),
        full(res_full + 1), empty(full + MAX_STAGES), st_full(empty + MAX_STAGES),
        st_empty(st_full + 2) {}
};

// The operand maps of a role. S (dQ) or S^T (dK, dV) = R T^T; X = dP (dQ) or
// dP^T (dK) = XA XB^T. R and XA are the block's own rows, T and XB the
// step's; dV's output product reads dO (U).
struct Maps {
  const CUtensorMap *r, *t, *xa, *xb, *u;
  __device__ Maps(int role, const CUtensorMap* q, const CUtensorMap* k, const CUtensorMap* v,
                  const CUtensorMap* dout)
      : r(role == sp::DQ ? q : k), t(role == sp::DQ ? k : q), xa(role == sp::DQ ? dout : v),
        xb(role == sp::DQ ? v : dout), u(dout) {}
};

// The producer (one thread): the resident tiles (with dQ's own lse and di),
// then each step's stats (dK, dV) and its ring items (Ops::ITEMS; _c: column
// block c, h the block's half) in the order they are taken.
template <int ROLE>
__device__ __forceinline__ void produce(unsigned char* res, const Maps& m,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ di, int L, int l_valid,
                                        int half) {
  using namespace hopper;
  using O = Ops<ROLE>;
  constexpr int STAGES = O::STAGES;
  unsigned char* ring = res + O::NRES * TILE;
  float* stats = reinterpret_cast<float*>(res + TILES * TILE);
  const Bars b(res);
  const int row0 = blockIdx.y * L, rb = row0 + blockIdx.x * BR;
  const int n_tiles = ROLE == sp::DQ ? (l_valid + BR - 1) / BR : L / BR;
  mbar_expect_tx(b.res_full, O::NRES * TILE + (ROLE == sp::DQ ? STATS * 4 : 0));
  for (int c = 0; c < CB; ++c) {
    sp::load_tile<W>(res + c * TILE, m.r, b.res_full, rb, c * W);
    if (!O::DV) sp::load_tile<W>(res + (CB + c) * TILE, m.xa, b.res_full, rb, c * W);
  }
  if (ROLE == sp::DQ) {
    bulk_load(stats, lse + rb, BR * 4, b.res_full);
    bulk_load(stats + BR, di + rb, BR * 4, b.res_full);
  }
  int n = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int ro = row0 + it * BR;
    if (ROLE != sp::DQ) {
      const int st = it % 2;
      mbar_wait(&b.st_empty[st], ((it / 2) & 1) ^ 1);
      mbar_expect_tx(&b.st_full[st], STATS * 4);
      bulk_load(stats + st * STATS, lse + ro, BR * 4, &b.st_full[st]);
      bulk_load(stats + st * STATS + BR, di + ro, BR * 4, &b.st_full[st]);
    }
    for (int k = 0; k < O::ITEMS; ++k, ++n) {
      const CUtensorMap* map = k < CB ? (O::DV ? m.t : m.xb) : (O::DV ? m.u : m.t);
      const int s = n % STAGES;
      mbar_wait(&b.empty[s], ((n / STAGES) & 1) ^ 1);
      mbar_expect_tx(&b.full[s], TILE);
      const int c = k < CB ? k : O::DV ? half : k - CB;
      sp::load_tile<W>(ring + s * TILE, map, &b.full[s], ro, c * W);
    }
  }
}

// A consumer warpgroup: output channels half W .. + W - 1 of the block's 64
// rows, in 128 registers a thread. Each step it forms X (dK, dQ) and S over
// all 512 channels, then P (and dS) in registers, and acc += A U: A = P^T
// (dV), dS^T (dK) or dS (dQ) as bf16 register operands, U = dO's half (dV)
// or T's half (dK, dQ; kept in the ring since S). Each chain is drained
// before its slots go back. dK, dQ: an item needs the slot of the item three
// before it (XB_0 XB_1 of the next step those of XB_1 and T_0, T_0 that of
// T_1), always released by then: the ring cannot deadlock. dQ walks only the
// key tiles below l_valid; dK and dV every query tile (a padded query row
// has dO = 0 and di = 0, so it adds nothing).
template <int ROLE>
__device__ __forceinline__ void consume(unsigned char* res, __nv_bfloat16* __restrict__ out,
                                        int L, int l_valid, float scale) {
  using namespace hopper;
  using O = Ops<ROLE>;
  constexpr int STAGES = O::STAGES;
  unsigned char* ring = res + O::NRES * TILE;
  float* stats = reinterpret_cast<float*>(res + TILES * TILE);
  const Bars b(res);
  const int rb = blockIdx.y * L + blockIdx.x * BR;
  const int n_tiles = ROLE == sp::DQ ? (l_valid + BR - 1) / BR : L / BR;
  const int half = blockIdx.z % CB;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  mbar_wait(b.res_full, 0);

  int n = 0;  // items taken from the ring
  for (int it = 0; it < n_tiles; ++it) {
    // descriptors rebuilt each step from an opaque base (as in sp::run_block)
    const uint64_t dres = desc_kmajor(opaque(smem_u32(res)));
    const uint64_t dring = desc_kmajor(opaque(smem_u32(ring)));
    auto slot = [&](int item) { return dring + ((item % STAGES) * TILE >> 4); };
    auto wait = [&](int item) { mbar_wait(&b.full[item % STAGES], (item / STAGES) & 1); };
    auto release = [&](int item) { mbar_arrive(&b.empty[item % STAGES]); };

    float xp[BR / 2];  // dP^T (dK) or dP (dQ): XA_0 XB_0^T + XA_1 XB_1^T
    if constexpr (!O::DV) {
      wait(n);
      wait(n + 1);
      wgmma_fence();
      sp::mma_ss<W>(xp, dres + (CB * TILE >> 4), slot(n), true);
      sp::mma_ss<W>(xp, dres + ((CB + 1) * TILE >> 4), slot(n + 1), false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xp);
      __syncwarp();
      if (lane == 0) {
        release(n);
        release(n + 1);
      }
      n += CB;
    }

    // S = R_0 T_0^T + R_1 T_1^T
    float sc[BR / 2];
    wait(n);
    wait(n + 1);
    if constexpr (!O::DV) fence_regs(xp);
    wgmma_fence();
    sp::mma_ss<W>(sc, dres, slot(n), true);
    sp::mma_ss<W>(sc, dres + (TILE >> 4), slot(n + 1), false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    const int own = n + half;  // T_half
    __syncwarp();
    if (lane == 0) {
      release(n + 1 - half);
      if (O::DV) release(own);  // dK, dQ keep T_half for the output product
    }
    n += CB;

    // P = exp(S scale - lse); dK and dQ: dS = P (X - di) scale
    sp::softmax_grad<ROLE>(sc, O::DV ? sc : xp, stats, b.st_full, b.st_empty, it, l_valid,
                           scale, warp, lane);
    uint32_t a[BR / 16][4];
    acc_to_a<BR / 8>(sc, a);  // bf(P^T), bf(dS^T) or bf(dS)

    const int item = O::DV ? n : own;
    if (O::DV) wait(item);
    const uint32_t u = opaque(smem_u32(ring)) + (item % STAGES) * TILE;
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
      wgmma_rs_n256_mn(acc, a[kk], desc_mnmajor(u + kk * 16 * 128, BR * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) release(item);
    if constexpr (O::DV) n += O::ITEMS - CB;
  }
  store_rows_bf16<W, C>(out + (size_t)rb * C + half * W, acc, warp, g, tq);
}

// q, k, v, dout: (B L, 512) bf16 maps, boxes of 64 columns x 64 rows.
// blockIdx.z = 2 role + half (dK, dQ, dV); the consumer warpgroup is threads
// 0-127, the producer thread 128.
__global__ void __launch_bounds__(160, 1)
attn_bwd_c512_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int L, int l_valid, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = align_1024(smem_raw);
  const int role = blockIdx.z / CB, half = blockIdx.z % CB;
  if (threadIdx.x == 0) {
    const Bars b(res);
    mbar_init(b.res_full, 1);
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(&b.full[s], 1);
      mbar_init(&b.empty[s], 4);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&b.st_full[s], 1);
      mbar_init(&b.st_empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      const Maps m(role, &tm_q, &tm_k, &tm_v, &tm_do);
      if (role == sp::DK) {
        produce<sp::DK>(res, m, lse, di, L, l_valid, half);
      } else if (role == sp::DV) {
        produce<sp::DV>(res, m, lse, di, L, l_valid, half);
      } else {
        produce<sp::DQ>(res, m, lse, di, L, l_valid, half);
      }
    }
    return;
  }
  if (role == sp::DK) {
    consume<sp::DK>(res, dk, L, l_valid, scale);
  } else if (role == sp::DV) {
    consume<sp::DV>(res, dv, L, l_valid, scale);
  } else {
    consume<sp::DQ>(res, dq, L, l_valid, scale);
  }
}

int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* di, void* dq, void* dk, void* dv, int B, int L, int l_valid,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t rows = (uint64_t)B * L;
  int err = hopper::make_map_bf16(&tq, q, rows, C, BR);
  if (!err) err = hopper::make_map_bf16(&tk, k, rows, C, BR);
  if (!err) err = hopper::make_map_bf16(&tv, v, rows, C, BR);
  if (!err) err = hopper::make_map_bf16(&tdo, dout, rows, C, BR);
  if (err) return err;
  using Q = __nv_bfloat16;
  const cudaError_t e = allow_smem(attn_bwd_c512_wgmma_kernel, SMEM);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_c512_wgmma_kernel<<<dim3(L / BR, B, 3 * CB), 160, SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<Q*>(dq), static_cast<Q*>(dk), static_cast<Q*>(dv), L, l_valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace wide

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: (B, L, C) contiguous, 16-byte aligned, fp32
// (dtype 0) or bf16 (dtype 1); lse, di: (B, L) fp32, 16-byte aligned.
// scratch: for fp32, 12 B L C bf16 (the operand pieces); unused for bf16. Takes
// C in {64, 128, 256, 512} and L % 128 == 0 (the Python wrapper pads other
// shapes to these and raises outside them); keys at or past l_valid (1 <=
// l_valid <= L) are masked. Returns a CUDA error code (cudaGetLastError()
// after the launches).
int gdt_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* di, void* dq, void* dk, void* dv,
                      void* scratch, int B, int L, int C, int l_valid, float scale, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lv = l_valid;
  if (dtype == 1) {
    switch (C) {
      case 64: return wg::launch<64>(q, k, v, dout, lse, di, dq, dk, dv, B, L, lv, scale, s);
      case 128: return wg::launch<128>(q, k, v, dout, lse, di, dq, dk, dv, B, L, lv, scale, s);
      case 256: return wg::launch<256>(q, k, v, dout, lse, di, dq, dk, dv, B, L, lv, scale, s);
      case 512:
        return wide::launch(q, k, v, dout, lse, di, dq, dk, dv, B, L, lv, scale, s);
    }
  } else if (dtype == 0) {
    void* w = scratch;
    switch (C) {
      case 64: return sp::launch<64>(q, k, v, dout, lse, di, dq, dk, dv, w, B, L, lv, scale, s);
      case 128: return sp::launch<128>(q, k, v, dout, lse, di, dq, dk, dv, w, B, L, lv, scale, s);
      case 256: return sp::launch<256>(q, k, v, dout, lse, di, dq, dk, dv, w, B, L, lv, scale, s);
      case 512: return sp::launch<512>(q, k, v, dout, lse, di, dq, dk, dv, w, B, L, lv, scale, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
