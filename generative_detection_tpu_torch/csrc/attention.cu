// Single-head attention forward, O = softmax(q k^T * C^-0.5) v, plus the row
// logsumexp, over (B, L, C) tensors, for Hopper (sm_90a); and the
// forward-only flash variant, which computes in fp32 whatever the input type.
//
// Replaces generative_detection_tpu/ops/attention.py `_mha_fwd_call` (kernel
// `_mha_fwd_kernel`) and `_attention_pallas` (kernel `_flash_kernel`). The
// TPU kernels keep the whole (L, C) K and V of one image in VMEM. On the
// H100 a block has at most 227 KB of shared memory: at C = 512 one bf16 K
// tile of 256 rows alone is 256 KB. So these kernels stream K/V tiles
// through shared memory with an online softmax (running max, running sum,
// fp32 accumulator).
//
// Bound on the H100 at the flagship sites: (B, 4096, 256) is compute-bound,
// (B, 256, 512) memory-bound (q, k, v read once, o written once). At
// (8, 4096, 256) the two products are 137.4 GFLOP: 0.139 ms in bf16 on the
// tensor cores, 2.05 ms in fp32 on the CUDA cores.
//
// bf16 runs attn_fwd_wgmma_kernel, a warp-specialized kernel
// (FlashAttention-3's layout). A producer warpgroup (one thread, 40
// registers) loads the block's Q once and streams K and V tiles by TMA into
// a two-stage ring of 128-byte swizzled shared memory, paced by full/empty
// mbarriers. Two consumer warpgroups (232 registers each) take 64 query rows
// each, as wgmma's M = 64 wants:
//   S = Q K^T       wgmma, both operands in shared memory;
//   online softmax  on the accumulator fragments in registers (a row lives
//                   in one quad: two shuffles), exp2 with log2(e) folded
//                   into the scale; l sums the fp32 P;
//   O += P V        P rounded to v's dtype (the rounding of
//                   `_mha_fwd_kernel`) and fed from registers as the A
//                   operand; V, MN-major, through the descriptor's
//                   transpose bit.
// Per channel count (Cfg below): at C = 64 (the tiny configs' (B, 256, 64)
// sites), 128 and 256 (the flagship's L = 4096 sites) a block owns 128 query
// rows and each warpgroup the whole O; at C = 512 (the (B, 256, 512)
// mid-block site, memory-bound and small) O does not fit one warpgroup's
// registers, so both warpgroups take the same 64 rows, each 256 of O's
// channels, and each computes S itself. At the end O /= l and lse = m +
// log(l). The flash variant on bf16 inputs (FLASH) is the same kernel with
// P kept to fp32 accuracy: its two bf16 pieces (hi, lo) feed two products
// with V (S needs one: a product of bf16 values is exact in fp32). Bound at
// (8, 4096, 256): 3 x 68.7 GFLOP / 989 TFLOP/s = 0.208 ms.
//
// fp32 at C = 64, 128, 256 runs attn_fwd_split_wgmma_kernel: both products
// on the tensor cores at fp32 accuracy. The CUDA cores' 67 TFLOP/s bound
// fp32 SDPA and any FMA kernel from below by 2.05 ms at (8, 4096, 256); the
// tensor cores take bf16 only, so every fp32 operand x becomes three bf16
// pieces x0 + x1 + x2 (split_bf16x2, to about 2^-25 of x) and each product
// the six piece products with i + j <= 2, accumulated in fp32 (the three
// left out are below 2^-24 relative). Bound: 6 x 137.4 GFLOP / 989 TFLOP/s
// = 0.833 ms. The pieces triple the bytes of every operand, so:
//   - a pre-pass (attn_fwd_split_operands_kernel) writes the pieces of q, k
//     and v to device memory once (18 bytes an element; ~0.08 ms at
//     (8, 4096, 256)) instead of every block splitting every K/V tile;
//   - a block owns 64 query rows and one consumer warpgroup: the three Q
//     pieces take 96 KB of shared memory at C = 256, O 128 registers a
//     thread, P's three pieces 48 more (formed in registers, fed as RS
//     A operands); a warp issues the TMA copies;
//   - K and V pieces stream one 64-row piece tile at a time through a
//     four-slot ring (K0 K1 K2 V0 V1 V2 per key tile), each slot released
//     as soon as the products that read it retire; V keeps its transpose
//     bit, which 16-bit pieces allow (a TF32 split would need V^T).
// fp32 at C = 512 (the (B, 256, 512) mid-block site) runs
// attn_fwd_split512_wgmma_kernel after the same pre-pass: three Q pieces and
// a 64 x 512 O do not fit one block, so a block owns 64 query rows and half
// of O's channels and streams 64 x 256 piece tiles (the C = 512 section
// below).
//
// Lengths off the grid: the wrapper pads L to a multiple of 128 with zero
// rows and passes the true length l_valid. Every kernel walks only the key
// tiles that hold a key below l_valid and sets the logits of the keys at or
// past it to -inf in the last one. The first tile always holds key 0, so a
// row's running max is finite from then on and no tile forms -inf - (-inf).
// Padded query rows (zero q) get a finite lse, log(l_valid).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialized (see the top of the file)
// ---------------------------------------------------------------------------

namespace wg {

// C = 64, 128, 256: a block owns 128 query rows, 64 per consumer
//   warpgroup, each with the whole O (64 x 256 fp32 is 128 registers a
//   thread); 64-row K/V tiles. At C = 64 a tile row is one 128-byte swizzle
//   chunk and P V is an m64n64 wgmma.
// C = 512: O (64 x 512) does not fit one warpgroup's registers. A block owns
//   64 query rows; each consumer warpgroup holds 256 of O's channels and
//   computes the same S itself (Q K^T runs twice: the (B, 256, 512) site is
//   memory-bound); 32-row K/V tiles keep two stages in shared memory.
template <int C>
struct Cfg {
  static constexpr int BQ = C <= 256 ? 128 : 64, BK = C <= 256 ? 64 : 32, STAGES = 2;
  static constexpr int CO = C <= 256 ? C : 256;  // output channels per consumer warpgroup
  static constexpr int CHUNKS = C / 64;  // 128-byte column chunks of a tile
  static constexpr uint32_t Q_BYTES = BQ * C * 2, KV_BYTES = BK * C * 2;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);
};

// FLASH: the flash variant (P in two bf16 pieces, no lse).
template <int C, bool FLASH>
__global__ void __launch_bounds__(384, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int L, int l_valid, float scale_log2) {
  using namespace hopper;
  using K = Cfg<C>;
  constexpr int BQ = K::BQ, BK = K::BK, STAGES = K::STAGES, CO = K::CO, CHUNKS = K::CHUNKS;
  constexpr int NP = FLASH ? 2 : 1;  // bf16 pieces of P
  constexpr uint32_t Q_BYTES = K::Q_BYTES, KV_BYTES = K::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);   // [CHUNKS][BQ][64]
  unsigned char* ks = qs + Q_BYTES;            // [STAGES][CHUNKS][BK][64]
  unsigned char* vs = ks + STAGES * KV_BYTES;  // [STAGES][CHUNKS][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

  const int row0 = blockIdx.y * L;  // the image's first row in the (B L, C) view
  const int q0 = blockIdx.x * BQ, n_tiles = (l_valid + BK - 1) / BK;  // the live key tiles
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int ch = 0; ch < CHUNKS; ++ch)
        tma_load_2d(qs + ch * BQ * 128, &tm_q, q_full, ch * 64, row0 + q0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&kv_empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], KV_BYTES);
        for (int ch = 0; ch < CHUNKS; ++ch)
          tma_load_2d(ks + s * KV_BYTES + ch * BK * 128, &tm_k, &k_full[s], ch * 64,
                      row0 + it * BK);
        mbar_expect_tx(&v_full[s], KV_BYTES);
        for (int ch = 0; ch < CHUNKS; ++ch)
          tma_load_2d(vs + s * KV_BYTES + ch * BK * 128, &tm_v, &v_full[s], ch * 64,
                      row0 + it * BK);
      }
    }
    return;
  }
  // ---- consumer warpgroups
  setmaxnreg_inc<232>();
  const int w = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = BQ == 128 ? 64 * w : 0;  // the warpgroup's first row in the block
  const int co0 = CO == C ? 0 : CO * w;     // and its first output channel
  const uint32_t q_addr = smem_u32(qs) + wrow * 128;

  float acc[CO / 2];
#pragma unroll
  for (int i = 0; i < CO / 2; ++i) acc[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};  // rows g, g + 8

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const uint32_t k_addr = smem_u32(ks + s * KV_BYTES);
    const uint32_t v_addr = smem_u32(vs + s * KV_BYTES) + (co0 / 64) * BK * 128;

    // S = Q K^T (raw logits; the scale is folded into the exponent)
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    mbar_wait(&k_full[s], ph);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss<BK>(sc, desc_kmajor(q_addr + (kk / 4) * BQ * 128 + col),
                   desc_kmajor(k_addr + (kk / 4) * BK * 128 + col), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mask_keys<BK, true>(sc, it * BK, l_valid, warp, g, tq);

    // online softmax in the log2 domain, rows g (h = 0) and g + 8 (h = 1)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[h], mx * scale_log2);
      alpha[h] = exp2f(m_row[h] - m_new);
      m_row[h] = m_new;
      l_row[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -m_row[e / 2]));
        sc[4 * j + e] = p;
        l_row[e / 2] += p;  // the fp32 P
      }
    }
    uint32_t pa[NP][BK / 16][4];
    acc_to_a_pieces<BK / 8, NP>(sc, pa);  // P rounded to v's dtype (FLASH: to about 2^-17)
#pragma unroll
    for (int j = 0; j < CO / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V over the warpgroup's CO channels
    mbar_wait(&v_full[s], ph);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = NP - 1; i >= 0; --i)
        wgmma_rs_mn<CO>(acc, pa[i][kk], desc_mnmajor(v_addr + kk * 16 * 128, BK * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  }

  // O / l, lse = m + log(l) (natural log)
  float inv[2];
  const int row = row0 + q0 + wrow + warp * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / l;
    if (!FLASH && tq == 0 && co0 == 0) lse[row + 8 * h] = (m_row[h] + log2f(l)) * kLn2;
  }
  __nv_bfloat16* orow = o + (size_t)row * C + co0 + 2 * tq;
#pragma unroll
  for (int j = 0; j < CO / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * C + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
  }
}

template <int C, bool FLASH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
           int l_valid, float scale, cudaStream_t stream) {
  using K = Cfg<C>;
  CUtensorMap tq, tk, tv;
  const uint64_t rows = (uint64_t)B * L;
  int err = hopper::make_map_bf16(&tq, q, rows, C, K::BQ);
  if (!err) err = hopper::make_map_bf16(&tk, k, rows, C, K::BK);
  if (!err) err = hopper::make_map_bf16(&tv, v, rows, C, K::BK);
  if (err) return err;
  auto kernel = attn_fwd_wgmma_kernel<C, FLASH>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(L / K::BQ, B), 384, K::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), L, l_valid,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// fp32: split-precision wgmma (see the top of the file)
// ---------------------------------------------------------------------------

namespace sp {

constexpr int NP = 3;  // bf16 pieces of every fp32 operand
// Key tiles whose P V products one wgmma accumulator chain sums. The tensor
// core's fp32 sum truncates, so a chain's error grows with its length: over
// a whole row of 65536 keys O missed 1e-3 of its RMS against float64 (1.5e-3;
// 2.4e-4 at 4096 keys). Every FLUSH_TILES key tiles (4096 keys) the
// accumulator is added into o with IEEE fp32 arithmetic (the partial scaled
// by the softmax's running max since the last flush) and restarts at zero;
// a row of at most 4096 keys never flushes.
constexpr int FLUSH_TILES = 64;

// A block: 64 query rows, one consumer warpgroup (threads 0-127) and one
// producer warp (128-159). Shared memory: the three Q pieces, then a ring
// of STAGES piece tiles (64 key rows x C, bf16), each in the 128-byte
// swizzle as C / 64 column chunks. At C = 256: 96 + 128 KB.
template <int C>
struct Cfg {
  static constexpr int BQ = 64, BK = 64, STAGES = 4, THREADS = 160;
  static constexpr int CHUNKS = C / 64;
  static constexpr uint32_t QP_BYTES = BQ * C * 2, TILE_BYTES = BK * C * 2;
  static constexpr size_t SMEM = 1024 + NP * QP_BYTES + STAGES * TILE_BYTES + 8 * (1 + 2 * STAGES);
  static_assert(STAGES >= NP, "a product needs all pieces of its operand in the ring");
};

// The pre-pass: x (fp32, n elements, n % 8 == 0) of q, k, v (blockIdx.y)
// into NP bf16 pieces, out[(t * NP + p) * n + i] = piece p of element i of
// tensor t.
__global__ void __launch_bounds__(256)
attn_fwd_split_operands_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, __nv_bfloat16* __restrict__ out,
                               size_t n) {
  const float* x = blockIdx.y == 0 ? q : blockIdx.y == 1 ? k : v;
  hopper::split_to_pieces<NP>(x, out + (size_t)blockIdx.y * NP * n, n);
}

// tm_q, tm_k, tm_v: (NP B L, C) bf16 maps over the pieces (piece p of row r
// at row p B L + r), boxes of 64 columns x 64 rows. o: (B L, C) fp32.
template <int C, bool LSE>
__global__ void __launch_bounds__(Cfg<C>::THREADS, 1)
attn_fwd_split_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                            float* __restrict__ lse, int L, int BL, int l_valid,
                            float scale_log2) {
  using namespace hopper;
  using K = Cfg<C>;
  constexpr int BQ = K::BQ, BK = K::BK, STAGES = K::STAGES, CHUNKS = K::CHUNKS;
  constexpr uint32_t QP_BYTES = K::QP_BYTES, TILE_BYTES = K::TILE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);    // [NP][CHUNKS][BQ][64]
  unsigned char* ring = qs + NP * QP_BYTES;    // [STAGES][CHUNKS][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * TILE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int row0 = blockIdx.y * L;  // the image's first row in the (B L, C) view
  const int q0 = blockIdx.x * BQ, n_tiles = (l_valid + BK - 1) / BK;  // the live key tiles
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: one thread issues every copy, piece tiles in the
    // order the consumer takes them: K0 K1 K2 V0 V1 V2 of each key tile
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_full, NP * QP_BYTES);
      for (int p = 0; p < NP; ++p)
        for (int ch = 0; ch < CHUNKS; ++ch)
          tma_load_2d(qs + p * QP_BYTES + ch * BQ * 128, &tm_q, q_full, ch * 64,
                      p * BL + row0 + q0);
      int n = 0;
      for (int it = 0; it < n_tiles; ++it)
        for (int op = 0; op < 2; ++op)
          for (int p = 0; p < NP; ++p, ++n) {
            const int s = n % STAGES;
            mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], TILE_BYTES);
            for (int ch = 0; ch < CHUNKS; ++ch)
              tma_load_2d(ring + s * TILE_BYTES + ch * BK * 128, op ? &tm_v : &tm_k, &full[s],
                          ch * 64, p * BL + row0 + it * BK);
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
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};  // rows g, g + 8
  float m_flush[2];  // the running max at the last flush
  const int row = row0 + q0 + warp * 16 + g;
  float* orow = o + (size_t)row * C + 2 * tq;

  mbar_wait(q_full, 0);
  int n = 0;  // piece tiles taken from the ring
  for (int it = 0; it < n_tiles; ++it) {
    if (it % FLUSH_TILES == 0 && it > 0) {
      // o = o * 2^(m_flush - m) + acc (o = acc the first time), acc = 0
      const bool add = it > FLUSH_TILES;
      float f[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f[h] = add ? exp2f(m_flush[h] - m_row[h]) : 0.f;
        m_flush[h] = m_row[h];
      }
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* dst = reinterpret_cast<float2*>(orow + 8 * h * C + 8 * j);
          const float2 old = add ? *dst : make_float2(0.f, 0.f);
          *dst = make_float2(fmaf(old.x, f[h], acc[4 * j + 2 * h]),
                             fmaf(old.y, f[h], acc[4 * j + 2 * h + 1]));
          acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.f;
        }
    }
    // descriptors of this tile's operands: rebuilt each tile from an opaque
    // base, so the compiler cannot keep the 48 of the Q pieces in registers
    const uint64_t dq = desc_kmajor(opaque(smem_u32(qs)));
    const uint64_t dring = desc_kmajor(opaque(smem_u32(ring)));
    const uint64_t dring_mn = desc_mnmajor(opaque(smem_u32(ring)), BK * 128);

    // S = sum over i + j <= 2 of Q_i K_j^T (raw logits; the scale is folded
    // into the exponent): one chain of products per K piece, started when
    // the piece lands and drained before its slot goes back to the producer
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j, ++n) {
      const int s = n % STAGES;
      mbar_wait(&full[s], (n / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int i = NP - 1 - j; i >= 0; --i)
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          wgmma_ss<BK>(sc, dq + ((i * QP_BYTES + (kk / 4) * BQ * 128 + col) >> 4),
                       dring + ((s * TILE_BYTES + (kk / 4) * BK * 128 + col) >> 4), 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    mask_keys<BK, true>(sc, it * BK, l_valid, warp, g, tq);

    // online softmax in the log2 domain, rows g (h = 0) and g + 8 (h = 1)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[h], mx * scale_log2);
      alpha[h] = exp2f(m_row[h] - m_new);
      m_row[h] = m_new;
      l_row[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -m_row[e / 2]));
        sc[4 * j + e] = p;
        l_row[e / 2] += p;
      }
    }
    uint32_t pa[NP][BK / 16][4];
    acc_to_a_pieces<BK / 8, NP>(sc, pa);
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += sum over i + j <= 2 of P_i V_j, one drained chain per V piece
#pragma unroll
    for (int j = 0; j < NP; ++j, ++n) {
      const int s = n % STAGES;
      mbar_wait(&full[s], (n / STAGES) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int i = NP - 1 - j; i >= 0; --i)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_mn<C>(acc, pa[i][kk], dring_mn + ((s * TILE_BYTES + kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // O / l, lse = m + log(l) (natural log); after a flush O = o 2^(m_flush
  // - m) + acc
  float inv[2], f[2];
  const bool flushed = n_tiles > FLUSH_TILES;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / l;
    f[h] = flushed ? exp2f(m_flush[h] - m_row[h]) : 0.f;
    if (LSE && tq == 0) lse[row + 8 * h] = (m_row[h] + log2f(l)) * kLn2;
  }
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* dst = reinterpret_cast<float2*>(orow + 8 * h * C + 8 * j);
      const float2 old = flushed ? *dst : make_float2(0.f, 0.f);
      *dst = make_float2(fmaf(old.x, f[h], acc[4 * j + 2 * h]) * inv[h],
                         fmaf(old.y, f[h], acc[4 * j + 2 * h + 1]) * inv[h]);
    }
}

// The pre-pass into scratch: NP * 3 * n bf16 (the pieces of q, k, v; n =
// B L C elements each).
int split_operands(const void* q, const void* k, const void* v, __nv_bfloat16* pieces, size_t n,
                   cudaStream_t stream) {
  const int blocks = (int)std::min<size_t>((n / 8 + 255) / 256, 132 * 8);
  attn_fwd_split_operands_kernel<<<dim3(blocks, 3), 256, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pieces, n);
  return (int)cudaGetLastError();
}

template <int C, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, void* scratch,
           int B, int L, int l_valid, float scale, cudaStream_t stream) {
  using K = Cfg<C>;
  const size_t n = (size_t)B * L * C;
  __nv_bfloat16* pieces = static_cast<__nv_bfloat16*>(scratch);
  int err = split_operands(q, k, v, pieces, n, stream);
  if (err) return err;
  CUtensorMap tq, tk, tv;
  const uint64_t rows = (uint64_t)NP * B * L;
  err = hopper::make_map_bf16(&tq, pieces, rows, C, K::BQ);
  if (!err) err = hopper::make_map_bf16(&tk, pieces + NP * n, rows, C, K::BK);
  if (!err) err = hopper::make_map_bf16(&tv, pieces + 2 * NP * n, rows, C, K::BK);
  if (err) return err;
  auto kernel = attn_fwd_split_wgmma_kernel<C, LSE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(L / K::BQ, B), K::THREADS, K::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(lse), L, B * L, l_valid,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

// ---- C = 512 ---------------------------------------------------------------
//
// A 64-row piece tile is 64 KB at C = 512 and a 64 x 512 fp32 O 256
// registers a thread, so the C <= 256 layout (three Q pieces resident, one
// warpgroup owning O) does not fit. As the fp32 backward at C = 512
// (attention_bwd.cu, run_block_wide): a block owns 64 query rows and one
// half of O's channels (W = 256: 128 registers, as at C = 256; blockIdx.z =
// half), and every piece tile is 64 rows x 256 columns (32 KB, one column
// block; a 512-wide row is two). Q_0's two column blocks stay resident (64
// KB); the other tiles stream through a ring of five, per key tile:
//   S: Q1 K2 K1 K0 Q2 of column block 0, then of column block 1, chains
//     S += (0,2) | (1,1) (0,1) | (1,0), frees Q1 | (2,0), and on the last
//     column block (0,0), frees the rest; then K0 of block 0 again for
//     block 0's (0,0). S is a contraction over all 512 channels in one
//     accumulator, and every small piece product goes in before either
//     leading (0, 0) one: the tensor core's fp32 accumulation rounds each
//     step to the accumulator's size (a second accumulator beside O would
//     spill; without the deferral the backward's peaked-softmax test failed);
//   the online softmax as at C <= 256, P split into three register pieces;
//   O += P_i V_j over the block's half: V2 V1 V0, smallest first.
// Both halves take the column blocks in the same order, so they form the
// same S and P bit for bit, and half 0 writes the lse. No more than five
// tiles are live at once, and every tile is freed before the tile five later
// needs its slot, so the ring cannot deadlock. The price of the halves: S is
// formed twice, 36 piece products of 64 x 64 x 256 per pair of blocks and
// key tile against the 24 of one pass; the grid, (L / 64, B, 2), is twice
// as many blocks as one 512-channel block per 64 rows would give.
constexpr int WIDE_C = 512, W = 256, CB = WIDE_C / W;  // two 256-column blocks

struct WideCfg {
  static constexpr int BR = 64, TILES = 7, STAGES = TILES - CB, THREADS = 160;
  static constexpr uint32_t TILE = BR * W * 2;  // one piece of a 64 x 256 tile
  // the tiles, 1 + 2 STAGES mbarriers
  static constexpr size_t SMEM = 1024 + TILES * TILE + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "shared memory");
};

// One (64, 256) piece tile by TMA: four 64 x 64 boxes from column col0.
__device__ __forceinline__ void load_wide_tile(unsigned char* dst, const CUtensorMap* map,
                                               uint64_t* bar, int row, int col0) {
#pragma unroll
  for (int ch = 0; ch < W / 64; ++ch)
    hopper::tma_load_2d(dst + ch * WideCfg::BR * 128, map, bar, col0 + ch * 64, row);
}

// d (64 x 64) (+)= A B^T over one 256-column block, A and B piece tiles in
// shared memory (descriptors of their first byte), both K-major; issued, not
// committed. `first`: the key tile's first product (scale-d 0). The
// descriptors pass through opaque() so that ptxas derives each wgmma's where
// it is issued instead of holding a chain's ahead of it.
__device__ __forceinline__ void mma_wide(float (&d)[WideCfg::BR / 2], uint64_t da, uint64_t db,
                                         bool first) {
  da = hopper::opaque(da);
  db = hopper::opaque(db);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint32_t off = ((kk / 4) * WideCfg::BR * 128 + (kk % 4) * 32) >> 4;
    hopper::wgmma_ss<WideCfg::BR>(d, da + off, db + off, !(first && kk == 0));
  }
}

// tm: the (3 NP B L, 512) bf16 map over the pieces (piece p of row r of
// operand t, q k v, at row (t NP + p) B L + r), boxes of 64 columns x 64
// rows. o: (B L, 512) fp32. blockIdx.z: O's channel half.
template <bool LSE>
__global__ void __launch_bounds__(WideCfg::THREADS, 1)
attn_fwd_split512_wgmma_kernel(const __grid_constant__ CUtensorMap tm, float* __restrict__ o,
                               float* __restrict__ lse, int L, int BL, int l_valid,
                               float scale_log2) {
  using namespace hopper;
  using K = WideCfg;
  constexpr int BR = K::BR, STAGES = K::STAGES;
  constexpr uint32_t TILE = K::TILE;
  constexpr int ITEMS = 5 * CB + 1 + NP;  // piece tiles a key tile: S's, K0 again, V's
  enum { OPQ, OPK, OPV };
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = align_1024(smem_raw);  // Q_0: [CB][W / 64][BR][64]
  unsigned char* ring = res + CB * TILE;      // [STAGES][W / 64][BR][64]
  uint64_t* res_full = reinterpret_cast<uint64_t*>(ring + STAGES * TILE);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + STAGES;

  const int half = blockIdx.z;  // O's channels half W .. + W - 1
  const int row0 = blockIdx.y * L, rq = row0 + blockIdx.x * BR;
  const int n_tiles = (l_valid + BR - 1) / BR;  // the live key tiles
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(res_full, CB * TILE);
      for (int c = 0; c < CB; ++c) load_wide_tile(res + c * TILE, &tm, res_full, rq, c * W);
      int n = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int rk = row0 + it * BR;
        for (int k = 0; k < ITEMS; ++k, ++n) {
          // (operand, piece, row, column block) of the key tile's k-th item
          int op, p, r, c;
          if (k < 5 * CB) {  // Q1 K2 K1 K0 Q2 of column block k / 5
            const int j = k % 5;
            const bool is_q = j == 0 || j == 4;
            op = is_q ? OPQ : OPK, p = j == 0 ? 1 : j == 4 ? 2 : 3 - j, r = is_q ? rq : rk;
            c = k / 5;
          } else if (k == 5 * CB) {  // K0 of column block 0 again
            op = OPK, p = 0, r = rk, c = 0;
          } else {  // V2 V1 V0 of the block's half
            op = OPV, p = NP - 1 - (k - 5 * CB - 1), r = rk, c = half;
          }
          const int s = n % STAGES;
          mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], TILE);
          load_wide_tile(ring + s * TILE, &tm, &full[s], (op * NP + p) * BL + r, c * W);
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
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};  // rows g, g + 8

  mbar_wait(res_full, 0);
  int n = 0;  // piece tiles taken from the ring
  for (int it = 0; it < n_tiles; ++it) {
    const uint64_t dres = desc_kmajor(opaque(smem_u32(res)));
    const uint64_t dring = desc_kmajor(opaque(smem_u32(ring)));
    const uint64_t dring_mn = desc_mnmajor(opaque(smem_u32(ring)), BR * 128);
    auto slot = [&](int item) { return dring + ((item % STAGES) * TILE >> 4); };
    auto wait = [&](int item) { mbar_wait(&full[item % STAGES], (item / STAGES) & 1); };
    auto free_slot = [&](int item) { mbar_arrive(&empty[item % STAGES]); };

    // S = sum of Q_i K_j^T over both column blocks (raw logits; the scale is
    // folded into the exponent), each column block's items Q1 K2 K1 K0 Q2
    float sc[BR / 2];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const uint64_t q0 = dres + ((c * TILE) >> 4);
      wait(n + 1);
      if (c) fence_regs(sc);
      wgmma_fence();
      mma_wide(sc, q0, slot(n + 1), c == 0);  // (0, 2)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      wait(n);
      wait(n + 2);
      fence_regs(sc);
      wgmma_fence();
      mma_wide(sc, slot(n), slot(n + 2), false);  // (1, 1)
      mma_wide(sc, q0, slot(n + 2), false);       // (0, 1)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      wait(n + 3);
      fence_regs(sc);
      wgmma_fence();
      mma_wide(sc, slot(n), slot(n + 3), false);  // (1, 0)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) free_slot(n);  // Q1
      wait(n + 4);
      fence_regs(sc);
      wgmma_fence();
      mma_wide(sc, slot(n + 4), slot(n + 3), false);       // (2, 0)
      if (c == CB - 1) mma_wide(sc, q0, slot(n + 3), false);  // (0, 0)
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0)
        for (int i = 1; i < 5; ++i) free_slot(n + i);  // K2 K1 K0 Q2
      n += 5;
    }
    // item n: K0 of column block 0 again, for its (0, 0)
    wait(n);
    fence_regs(sc);
    wgmma_fence();
    mma_wide(sc, dres, slot(n), false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) free_slot(n);
    n += 1;
    mask_keys<BR, true>(sc, it * BR, l_valid, warp, g, tq);

    // online softmax in the log2 domain, rows g (h = 0) and g + 8 (h = 1)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BR / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[h], mx * scale_log2);
      alpha[h] = exp2f(m_row[h] - m_new);
      m_row[h] = m_new;
      l_row[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -m_row[e / 2]));
        sc[4 * j + e] = p;
        l_row[e / 2] += p;
      }
    }
    uint32_t pa[NP][BR / 16][4];
    acc_to_a_pieces<BR / 8, NP>(sc, pa);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += sum over i + j <= 2 of P_i V_j over the block's half, one drained
    // chain per V piece, V_{2-q} at item n + q
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int s = (n + q) % STAGES;
      wait(n + q);
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
    n += NP;
  }

  // O / l, lse = m + log(l) (natural log; half 0 writes it)
  float inv[2];
  const int row = rq + warp * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / l;
    if (LSE && half == 0 && tq == 0) lse[row + 8 * h] = (m_row[h] + log2f(l)) * kLn2;
  }
  float* orow = o + (size_t)row * WIDE_C + half * W + 2 * tq;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    *reinterpret_cast<float2*>(orow + 8 * j) =
        make_float2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
    *reinterpret_cast<float2*>(orow + 8 * WIDE_C + 8 * j) =
        make_float2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
  }
}

template <bool LSE>
int launch_wide(const void* q, const void* k, const void* v, void* o, void* lse, void* scratch,
                int B, int L, int l_valid, float scale, cudaStream_t stream) {
  using K = WideCfg;
  __nv_bfloat16* pieces = static_cast<__nv_bfloat16*>(scratch);
  int err = split_operands(q, k, v, pieces, (size_t)B * L * WIDE_C, stream);
  if (err) return err;
  CUtensorMap tm;
  err = hopper::make_map_bf16(&tm, pieces, (uint64_t)3 * NP * B * L, WIDE_C, K::BR);
  if (err) return err;
  auto kernel = attn_fwd_split512_wgmma_kernel<LSE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(L / K::BR, B, CB), K::THREADS, K::SMEM, stream>>>(
      tm, static_cast<float*>(o), static_cast<float*>(lse), L, B * L, l_valid,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace sp

// fp32 forward, with or without the lse: split precision at every width.
template <bool LSE>
int launch_fp32(const void* q, const void* k, const void* v, void* o, void* lse, void* scratch,
                int B, int L, int C, int lv, float scale, cudaStream_t s) {
  switch (C) {
    case 64: return sp::launch<64, LSE>(q, k, v, o, lse, scratch, B, L, lv, scale, s);
    case 128: return sp::launch<128, LSE>(q, k, v, o, lse, scratch, B, L, lv, scale, s);
    case 256: return sp::launch<256, LSE>(q, k, v, o, lse, scratch, B, L, lv, scale, s);
    case 512: return sp::launch_wide<LSE>(q, k, v, o, lse, scratch, B, L, lv, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool FLASH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
                int C, int lv, float scale, cudaStream_t s) {
  switch (C) {
    case 64: return wg::launch<64, FLASH>(q, k, v, o, lse, B, L, lv, scale, s);
    case 128: return wg::launch<128, FLASH>(q, k, v, o, lse, B, L, lv, scale, s);
    case 256: return wg::launch<256, FLASH>(q, k, v, o, lse, B, L, lv, scale, s);
    case 512: return wg::launch<512, FLASH>(q, k, v, o, lse, B, L, lv, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, o: (B, L, C) contiguous, 16-byte aligned, fp32 (dtype 0) or bf16
// (dtype 1); lse: (B, L) fp32. scratch: for fp32, 9 B L C bf16 (the
// operand pieces), else unused. Takes C in {64, 128, 256, 512} and L %
// 128 == 0 (the Python wrapper pads other shapes to these and raises
// outside them); keys at or past l_valid (1 <= l_valid <= L) are masked.
// Returns a CUDA error code (cudaGetLastError() after the launch).
int gdt_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                      void* scratch, int B, int L, int C, int l_valid, float scale, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16<false>(q, k, v, o, lse, B, L, C, l_valid, scale, s);
  if (dtype == 0) return launch_fp32<true>(q, k, v, o, lse, scratch, B, L, C, l_valid, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The forward-only flash variant (B5): q, k, v, o and scratch as above,
// computed to fp32 accuracy throughout (products and P), no lse. Replaces
// generative_detection_tpu/ops/attention.py `_attention_pallas` (kernel
// `_flash_kernel`), which upcasts q, k, v to fp32 and runs both products in
// fp32. Same shape limits as gdt_attention_fwd.
int gdt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                            void* scratch, int B, int L, int C, int l_valid, float scale,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16<true>(q, k, v, o, nullptr, B, L, C, l_valid, scale, s);
  if (dtype == 0)
    return launch_fp32<false>(q, k, v, o, nullptr, scratch, B, L, C, l_valid, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
