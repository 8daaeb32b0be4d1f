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
// bf16 runs wgrad_wgmma_kernel. Block (c tile of 64, co tile of 128, point
// a, split s) walks chunks of KC = 32 columns of one t-row (the last chunk
// of a row may run past W: zero there), three warpgroups:
//   - thread 0 loads each chunk's raw rows by TMA two chunks ahead, into a
//     two-stage ring paced by an mbarrier per stage (z: the M + 2 rows of
//     the t-row, 64 channels; dy: its M rows, 128 channels, KC + 2 columns
//     from x0 - 1; rows and columns outside the tensor read as zero);
//   - all 384 threads then form the chunk's operands into a two-stage ring
//     of 128-byte-swizzled tiles: silu(z a + b) recomputed in fp32 and
//     rounded to bf16 (as the plain version), V_a summed in fp32 and cast to
//     bf16, dM_a summed in bf16;
//   - warpgroups 1 and 2, one per 64 output channels, then start
//     m64n192k16 wgmma on the tiles and wait for them only before the next
//     barrier (ptxas adds a wait where the accumulator leaves the consumers'
//     branch, C7517; the products are a small share of a chunk's time).
//     Both operands are MN-major:
//     A = V_a^T (64 channels x KC positions, channels contiguous) and B =
//     [dM_a shifted by 0 | 1 | 2 columns] (KC x 3 * 64). The dx shift is
//     carried in N: row x of B's chunk dx holds dM_a[x + 1 - dx], so one
//     64 x 192 fp32 accumulator (96 registers a thread) holds dU[a, 0..2]
//     for the warpgroup's channels. A shift of V_a instead would move the
//     operand by one K row, which breaks the 8-row swizzle atom.
// One barrier a chunk orders it: operand writes, the async-proxy fence, the
// wait for the previous chunk's products, the barrier, then the next TMA
// and this chunk's wgmma. The point a is a template argument of the operand
// code (form_chunk), so zero transform coefficients cost nothing.
//
// fp32 runs wgrad_split_wgmma_kernel: the same grid and pipeline on the
// bf16 tensor cores at fp32 accuracy, as the fp32 attention does. V_a and
// dM_a are formed and summed in fp32 (silu recomputed in fp32, no rounding
// to bf16) and written as three bf16 pieces each (split_bf16x2: x0 + x1 +
// x2 carries x to about 2^-25 of its size); each chunk runs the six piece
// products with i + j <= 2, the small ones first, into the fp32
// accumulator. What changes against bf16:
//   - KC = 16 positions a chunk: the raw rows are fp32 (60 KB a stage at
//     F(4,3)) and the operand stage holds three pieces of V_a^T and of the
//     three dx-shifted dM_a copies (42 KB), so two stages of each fit in
//     205 KB;
//   - the dx shift stays in N (m64n192k16, one k step a product);
//   - a block takes 128 output channels whatever CO % 128: where CO % 128
//     == 64 the second warpgroup's dy box lies past the tensor (TMA fills
//     zeros) and its products are not stored;
//   - the tensor core's fp32 sum truncates to the accumulator's size, so
//     the error grows with the chain of products a block sums: the wrapper
//     picks splits so that no block sums more than 4096 positions
//     (ops/conv3x3.py `_wgrad_splits`; the split attention backward's error
//     at L = 4096 was ~2e-4 of the RMS), and the fold adds the partials in
//     fp32.
//
// Bound on the H100: compute, on the direct-conv yardstick (2 * 9 * B * H *
// W * C * CO flops; the Winograd form does P * 3 / (9 * M) of them). What
// holds the bf16 kernel back is forming the operands, not the products: it
// reads z from L2 (M + 2) / M times per (point, co tile) and dy once per
// (point, c tile), about 2.9 GB at 16x128x128x256->128, and recomputes the
// activation once per (point, co tile). The fp32 kernel reads fp32 rows
// (about 6 GB from L2 at that site, by the same model with 16-position
// chunks) and runs six times the products: 6 x 77.3 GFLOP there, 0.469 ms
// at the bf16 peak.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

#include "hopper.cuh"
#include "winograd.cuh"

namespace {

constexpr int TC = 64;  // input channels per block

struct Geom {
  int B, H, W, C, CO;
  int HT;        // t-rows per image: H / M
  int n_xc;      // column chunks per t-row: ceil(W / chunk)
  int n_chunks;  // B * HT * n_xc
  int splits;
};

// Chunk k of KC columns: image b, t-row t, columns x0 .. x0 + KC - 1.
template <int KC>
__device__ __forceinline__ void chunk_coords(const Geom& g, int k, int* b, int* t, int* x0) {
  const int xc = k % g.n_xc;
  const int row = k / g.n_xc;  // image * HT + t
  *t = row % g.HT;
  *b = row / g.HT;
  *x0 = xc * KC;
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

// ---------------------------------------------------------------------------
// bf16: TMA + a transform-producer warpgroup + wgmma (see the top of the file)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int KC = 32;         // positions (columns of one t-row) per chunk
constexpr int TNW = 128;       // output channels per block, 64 per consumer warpgroup
constexpr int RS = 2, OS = 2;  // stages of the raw and the operand ring

template <int M>
struct Cfg {
  static constexpr int P = M + 2;
  static constexpr uint32_t Z_BYTES = 64 * KC * P * 2;       // z box: 64 C x KC x P rows
  static constexpr uint32_t DY_BOX = 64 * (KC + 2) * M * 2;  // dy box: 64 CO x (KC + 2) x M
  static constexpr uint32_t RAW_BYTES = Z_BYTES + 2 * DY_BOX;
  static constexpr uint32_t A_BYTES = KC * 128;      // V_a^T: KC rows of 64 channels
  static constexpr uint32_t B_BYTES = 6 * KC * 128;  // [warpgroup][dx]: KC rows of 64 CO
  static constexpr uint32_t OP_BYTES = A_BYTES + B_BYTES;
  static constexpr size_t SMEM = 1024 + OS * OP_BYTES + RS * RAW_BYTES + 8 * RS;
  static_assert(OP_BYTES % 1024 == 0 && RAW_BYTES % 128 == 0 && DY_BOX % 128 == 0, "align");
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Row k, 16-byte unit u of a 128-byte-swizzled tile (base 1024-aligned).
__device__ __forceinline__ uint32_t swz(int k, int u) {
  return k * 128 + ((u ^ (k & 7)) << 4);
}

// v += BT[A, R] act(z row R) on the 4 channels at byte `off` of column k;
// z row R outside the image (R = 0 of the first t-row, R = M + 1 of the
// last) adds nothing.
template <int M, bool GN, int A, int R>
__device__ __forceinline__ void add_z_row(float (&v)[4], const unsigned char* rz, int k, int off,
                                          bool first, bool last, const float4& ga4,
                                          const float4& gb4) {
  constexpr float cf = bt_c(M, A, R);
  if constexpr (cf != 0.f) {
    if ((R == 0 && first) || (R == M + 1 && last)) return;
    const uint2 raw = *reinterpret_cast<const uint2*>(rz + (R * KC + k) * 128 + off);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 z01 = __bfloat1622float2(h[0]), z23 = __bfloat1622float2(h[1]);
    float zr[4] = {z01.x, z01.y, z23.x, z23.y};
    if constexpr (GN) {
      const float gav[4] = {ga4.x, ga4.y, ga4.z, ga4.w}, gbv[4] = {gb4.x, gb4.y, gb4.z, gb4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = fmaf(zr[j], gav[j], gbv[j]);
        zr[j] = bf16_round(__fdividef(w, 1.f + __expf(-w)));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = cf == 1.f ? v[j] + zr[j] : fmaf(cf, zr[j], v[j]);
  }
}

// d += AT[R, A] dy row R in bf16, one rounding per add (bf16x2 fma: the
// product by a power of two is exact, so one rounding of d + cf r equals the
// plain version's fp32 add rounded to bf16).
template <int M, int A, int R>
__device__ __forceinline__ void add_dy_row(__nv_bfloat162 (&d)[4], const unsigned char* row) {
  constexpr float cf = at_c(M, R, A);
  if constexpr (cf != 0.f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + R * ((KC + 2) * 128));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const __nv_bfloat162 c2 = __float2bfloat162_rn(cf);
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = __hfma2(c2, h[j], d[j]);
  }
}

template <int M, bool GN, int A, int... R>
__device__ __forceinline__ void add_z_rows(std::integer_sequence<int, R...>, float (&v)[4],
                                           const unsigned char* rz, int k, int off, bool first,
                                           bool last, const float4& ga4, const float4& gb4) {
  (add_z_row<M, GN, A, R>(v, rz, k, off, first, last, ga4, gb4), ...);
}

template <int M, int A, int... R>
__device__ __forceinline__ void add_dy_rows(std::integer_sequence<int, R...>,
                                            __nv_bfloat162 (&d)[4], const unsigned char* row) {
  (add_dy_row<M, A, R>(d, row), ...);
}

// One chunk's operands for point A, formed by thread `tid` of 384:
// - V_a^T into the A tile: item (k, u, h) is column x0 + k, channels c0 +
//   8 u + 4 h .. + 3 (zero past the image's last column); 2 KC * 8 items,
//   one or two a thread (the activation is most of a chunk's work);
// - dM_a into B, by threads 128..383: item (jr, q) is column x0 - 1 + jr,
//   channels co0 + 8 q .. + 7, written to B chunk (q / 8, dx) at row k =
//   jr - 2 + dx, so that B_dx[k] = dM_a[x0 + k + 1 - dx].
template <int M, bool GN, int A>
__device__ __forceinline__ void form_chunk(unsigned char* op_a, const unsigned char* rz,
                                           const float* __restrict__ ga,
                                           const float* __restrict__ gb, const Geom& g, int b,
                                           int t, int x0, int c0, int tid) {
  constexpr int NV = KC * 16, ND = (KC + 2) * 16;
  const bool first = t == 0, last = t == g.HT - 1;
  for (int it = tid; it < NV; it += 384) {
    const int k = it >> 4, off = (it & 15) * 8;  // byte offset of the 4 channels in the row
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (!GN || x0 + k < g.W) {
      float4 ga4, gb4;
      if constexpr (GN) {
        ga4 = *reinterpret_cast<const float4*>(ga + (size_t)b * g.C + c0 + off / 2);
        gb4 = *reinterpret_cast<const float4*>(gb + (size_t)b * g.C + c0 + off / 2);
      }
      add_z_rows<M, GN, A>(std::make_integer_sequence<int, M + 2>{}, v, rz, k, off, first, last,
                           ga4, gb4);
    }
    uint2 out;
    out.x = hopper::pack_bf16(v[0], v[1]);
    out.y = hopper::pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(op_a + swz(k, off >> 4) + (off & 8)) = out;
  }
  if (tid < 128) return;
  unsigned char* op_b = op_a + Cfg<M>::A_BYTES;
  const unsigned char* rdy = rz + Cfg<M>::Z_BYTES;
  for (int it = tid - 128; it < ND; it += 256) {
    const int jr = it >> 4, q = it & 15;
    const int cc = q >> 3, u = q & 7;
    __nv_bfloat162 d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = __float2bfloat162_rn(0.f);
    const unsigned char* row = rdy + cc * Cfg<M>::DY_BOX + jr * 128 + u * 16;
    add_dy_rows<M, A>(std::make_integer_sequence<int, M>{}, d, row);
    const uint4 out = *reinterpret_cast<const uint4*>(d);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int k = jr - 2 + dx;
      if (k >= 0 && k < KC)
        *reinterpret_cast<uint4*>(op_b + (cc * 3 + dx) * (KC * 128) + swz(k, u)) = out;
    }
  }
}

template <int M, bool GN, int A = 0>
__device__ __forceinline__ void form_chunk_at(int a, unsigned char* op_a,
                                              const unsigned char* rz, const float* ga,
                                              const float* gb, const Geom& g, int b, int t,
                                              int x0, int c0, int tid) {
  if constexpr (A < M + 2) {
    if (a == A)
      form_chunk<M, GN, A>(op_a, rz, ga, gb, g, b, t, x0, c0, tid);
    else
      form_chunk_at<M, GN, A + 1>(a, op_a, rz, ga, gb, g, b, t, x0, c0, tid);
  }
}

// grid: ((C / 64) * (CO / 128) * P, splits); part: (splits, P*3, C, CO) fp32
template <int M, bool GN>
__global__ void __launch_bounds__(384, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap tm_z,
                   const __grid_constant__ CUtensorMap tm_dy, const float* __restrict__ ga,
                   const float* __restrict__ gb, float* __restrict__ part, Geom g) {
  using namespace hopper;
  using K = Cfg<M>;
  constexpr int P = K::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ops = align_1024(smem_raw);    // [OS][A | B]
  unsigned char* raws = ops + OS * K::OP_BYTES;  // [RS][z | dy chunk 0 | dy chunk 1]
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(raws + RS * K::RAW_BYTES);

  int bx = blockIdx.x;
  const int a = bx % P;
  bx /= P;
  const int n_cot = g.CO / TNW;
  const int co0 = (bx % n_cot) * TNW, c0 = (bx / n_cot) * TC;
  const int s = blockIdx.y;
  const int k0 = (int)((long long)s * g.n_chunks / g.splits);
  const int nk = (int)((long long)(s + 1) * g.n_chunks / g.splits) - k0;
  const int tid = threadIdx.x;

  auto load_chunk = [&](int i) {  // thread 0: the raw rows of chunk i
    int b, t, x0;
    chunk_coords<KC>(g, k0 + i, &b, &t, &x0);
    unsigned char* dst = raws + (i % RS) * K::RAW_BYTES;
    uint64_t* bar = &raw_full[i % RS];
    mbar_expect_tx(bar, K::RAW_BYTES);
    tma_load_4d(dst, &tm_z, bar, c0, x0, M * t - 1, b);
    tma_load_4d(dst + K::Z_BYTES, &tm_dy, bar, co0, x0 - 1, M * t, b);
    tma_load_4d(dst + K::Z_BYTES + K::DY_BOX, &tm_dy, bar, co0 + 64, x0 - 1, M * t, b);
  };
  if (tid == 0) {
    for (int i = 0; i < RS; ++i) mbar_init(&raw_full[i], 1);
    mbar_fence_init();
    for (int i = 0; i < RS && i < nk; ++i) load_chunk(i);
  }
  __syncthreads();

  // warpgroup 0 (threads 0..127) only forms operands; warpgroups 1 and 2 also
  // multiply, w taking output channels co0 + 64 w .. + 63
  const int w = __shfl_sync(0xffffffffu, tid / 128, 0) - 1;  // warp-uniform for ptxas
  const int warp = (tid / 32) % 4, lane = tid % 32;
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  const uint32_t b_off = K::A_BYTES + (w < 0 ? 0 : w) * 3 * (KC * 128);
  for (int i = 0; i < nk; ++i) {
    // chunk i's operands into stage i % OS, formed by every thread; the
    // products of chunk i - 2 read the stage last, and the consumers waited
    // for them before the previous barrier
    int b, t, x0;
    chunk_coords<KC>(g, k0 + i, &b, &t, &x0);
    mbar_wait(&raw_full[i % RS], (i / RS) & 1);
    form_chunk_at<M, GN>(a, ops + (i % OS) * K::OP_BYTES, raws + (i % RS) * K::RAW_BYTES, ga,
                         gb, g, b, t, x0, c0, tid);
    fence_proxy_async();
    if (w >= 0) {
      wgmma_wait<0>();  // chunk i - 1's products: stage (i + 1) % OS is free after the barrier
      fence_regs(acc);
    }
    __syncthreads();
    if (tid == 0 && i + RS < nk) load_chunk(i + RS);  // raw stage i % RS has been read
    if (w >= 0) {
      const uint32_t a_addr = smem_u32(ops + (i % OS) * K::OP_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_ss_n192_tt(acc, desc_mnmajor(a_addr + kk * 2048, KC * 128),
                         desc_mnmajor(a_addr + b_off + kk * 2048, KC * 128));
      wgmma_commit();
    }
  }
  if (w < 0) return;
  wgmma_wait<0>();
  fence_regs(acc);
  // rows c0 + 16 warp + g (+ 8), columns n = 8 j + 2 tq (+ 1): dx = n / 64
  const int g8 = lane >> 2, tq = lane & 3;
  const size_t plane = (size_t)g.C * g.CO;
  float* base = part + ((size_t)s * P + a) * 3 * plane + (size_t)(c0 + 16 * warp + g8) * g.CO +
                co0 + 64 * w + 2 * tq;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    float* dst = base + (j / 8) * plane + 8 * (j % 8);
    *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(dst + 8 * g.CO) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int M, bool GN>
int launch(const void* z, const void* dy, const void* ga, const void* gb, void* part,
           const Geom& g, cudaStream_t stream) {
  using K = Cfg<M>;
  CUtensorMap tz, tdy;
  const uint64_t dz[4] = {(uint64_t)g.C, (uint64_t)g.W, (uint64_t)g.H, (uint64_t)g.B};
  const uint64_t ddy[4] = {(uint64_t)g.CO, (uint64_t)g.W, (uint64_t)g.H, (uint64_t)g.B};
  const uint32_t bz[4] = {64, KC, M + 2, 1};
  const uint32_t bdy[4] = {64, KC + 2, M, 1};
  int err = hopper::make_map_bf16_nd(&tz, z, dz, bz);
  if (!err) err = hopper::make_map_bf16_nd(&tdy, dy, ddy, bdy);
  if (err) return err;
  auto kernel = wgrad_wgmma_kernel<M, GN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.C / TC) * (g.CO / TNW) * K::P, g.splits);
  kernel<<<grid, 384, K::SMEM, stream>>>(tz, tdy, static_cast<const float*>(ga),
                                         static_cast<const float*>(gb),
                                         static_cast<float*>(part), g);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// fp32: split-precision wgmma (see the top of the file)
// ---------------------------------------------------------------------------

namespace sp {

constexpr int NP = 3;          // bf16 pieces of every fp32 operand
constexpr int KC = 16;         // positions per chunk: one k step a piece product
constexpr int TNW = 128;       // output channels per block, 64 per consumer warpgroup
constexpr int RS = 2, OS = 2;  // stages of the raw and the operand ring
constexpr uint32_t ROW = 64 * 4;    // a raw row: 64 fp32 channels
constexpr uint32_t TILE = KC * 128;  // a bf16 operand tile: KC rows of 64 channels

template <int M>
struct Cfg {
  static constexpr int P = M + 2;
  static constexpr uint32_t Z_BYTES = ROW * KC * P;         // z box: 64 C x KC x P rows
  static constexpr uint32_t DY_BOX = ROW * (KC + 2) * M;    // dy box: 64 CO x (KC + 2) x M
  static constexpr uint32_t RAW_BYTES = Z_BYTES + 2 * DY_BOX;
  static constexpr uint32_t A_BYTES = NP * TILE;            // [piece]: V_a^T
  static constexpr uint32_t B_WG = NP * 3 * TILE;           // [piece][dx]: one warpgroup's B
  static constexpr uint32_t OP_BYTES = A_BYTES + 2 * B_WG;  // A | B of warpgroup 1 | of 2
  static constexpr size_t SMEM = 1024 + OS * OP_BYTES + RS * RAW_BYTES + 8 * RS;
  static_assert(OP_BYTES % 1024 == 0 && RAW_BYTES % 128 == 0 && DY_BOX % 128 == 0, "align");
  static_assert(SMEM <= 232448, "shared memory");
};

// v += BT[A, R] act(z row R) on the 4 channels at byte `off` of column k, in
// fp32 (x a + b rounded twice, as the plain version's product and sum); z
// row R outside the image adds nothing.
template <int M, bool GN, int A, int R>
__device__ __forceinline__ void add_z_row(float (&v)[4], const unsigned char* rz, int k, int off,
                                          bool first, bool last, const float4& ga4,
                                          const float4& gb4) {
  constexpr float cf = bt_c(M, A, R);
  if constexpr (cf != 0.f) {
    if ((R == 0 && first) || (R == M + 1 && last)) return;
    const float4 r = *reinterpret_cast<const float4*>(rz + (R * KC + k) * ROW + off);
    float zr[4] = {r.x, r.y, r.z, r.w};
    if constexpr (GN) {
      const float gav[4] = {ga4.x, ga4.y, ga4.z, ga4.w}, gbv[4] = {gb4.x, gb4.y, gb4.z, gb4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = __fadd_rn(__fmul_rn(zr[j], gav[j]), gbv[j]);
        zr[j] = __fdividef(w, 1.f + __expf(-w));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = cf == 1.f ? v[j] + zr[j] : fmaf(cf, zr[j], v[j]);
  }
}

// d += AT[R, A] dy row R on 8 output channels, in fp32 (the products by
// powers of two are exact: one rounding an add, as the plain version's)
template <int M, int A, int R>
__device__ __forceinline__ void add_dy_row(float (&d)[8], const unsigned char* row) {
  constexpr float cf = at_c(M, R, A);
  if constexpr (cf != 0.f) {
    const float4* r = reinterpret_cast<const float4*>(row + R * ((KC + 2) * ROW));
    const float4 lo = r[0], hi = r[1];
    const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = fmaf(cf, x[j], d[j]);
  }
}

template <int M, bool GN, int A, int... R>
__device__ __forceinline__ void add_z_rows(std::integer_sequence<int, R...>, float (&v)[4],
                                           const unsigned char* rz, int k, int off, bool first,
                                           bool last, const float4& ga4, const float4& gb4) {
  (add_z_row<M, GN, A, R>(v, rz, k, off, first, last, ga4, gb4), ...);
}

template <int M, int A, int... R>
__device__ __forceinline__ void add_dy_rows(std::integer_sequence<int, R...>, float (&d)[8],
                                            const unsigned char* row) {
  (add_dy_row<M, A, R>(d, row), ...);
}

// One chunk's operand pieces for point A, formed by thread `tid` of 384 in
// one loop over NV + ND items (NV a multiple of 32: every warp takes one
// kind of item a round):
// - item it < NV = KC * 16: V_a^T at column x0 + k, channels c0 + 4 q ..
//   + 3 (zero past the image's last column), its pieces into A piece p;
// - else dM_a at column x0 - 1 + jr, channels co0 + 64 cc + 8 u .. + 7,
//   written to B (warpgroup cc, piece p, dx) at row k = jr - 2 + dx, so
//   that B_dx[k] = dM_a[x0 + k + 1 - dx].
template <int M, bool GN, int A>
__device__ __forceinline__ void form_chunk(unsigned char* op, const unsigned char* rz,
                                           const float* __restrict__ ga,
                                           const float* __restrict__ gb, const Geom& g, int b,
                                           int t, int x0, int c0, int tid) {
  using K = Cfg<M>;
  constexpr int NV = KC * 16, ND = (KC + 2) * 16;
  const bool first = t == 0, last = t == g.HT - 1;
  for (int it = tid; it < NV + ND; it += 384) {
    if (it < NV) {
      const int k = it >> 4, q = it & 15;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (!GN || x0 + k < g.W) {
        float4 ga4, gb4;
        if constexpr (GN) {
          ga4 = *reinterpret_cast<const float4*>(ga + (size_t)b * g.C + c0 + 4 * q);
          gb4 = *reinterpret_cast<const float4*>(gb + (size_t)b * g.C + c0 + 4 * q);
        }
        add_z_rows<M, GN, A>(std::make_integer_sequence<int, M + 2>{}, v, rz, k, q * 16, first,
                             last, ga4, gb4);
      }
      uint32_t lo[NP], hi[NP];
      hopper::split_bf16x2(v[0], v[1], lo);
      hopper::split_bf16x2(v[2], v[3], hi);
      const uint32_t off = wg::swz(k, q >> 1) + (q & 1) * 8;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        *reinterpret_cast<uint2*>(op + p * TILE + off) = make_uint2(lo[p], hi[p]);
    } else {
      const int jr = (it - NV) >> 4, cc = (it >> 3) & 1, u = it & 7;
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = 0.f;
      add_dy_rows<M, A>(std::make_integer_sequence<int, M>{}, d,
                        rz + K::Z_BYTES + cc * K::DY_BOX + jr * ROW + u * 32);
      uint32_t w[4][NP];
#pragma unroll
      for (int e = 0; e < 4; ++e) hopper::split_bf16x2(d[2 * e], d[2 * e + 1], w[e]);
      unsigned char* ob = op + K::A_BYTES + cc * K::B_WG;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int k = jr - 2 + dx;
        if (k >= 0 && k < KC) {
#pragma unroll
          for (int p = 0; p < NP; ++p)
            *reinterpret_cast<uint4*>(ob + (p * 3 + dx) * TILE + wg::swz(k, u)) =
                make_uint4(w[0][p], w[1][p], w[2][p], w[3][p]);
        }
      }
    }
  }
}

template <int M, bool GN, int A = 0>
__device__ __forceinline__ void form_chunk_at(int a, unsigned char* op, const unsigned char* rz,
                                              const float* ga, const float* gb, const Geom& g,
                                              int b, int t, int x0, int c0, int tid) {
  if constexpr (A < M + 2) {
    if (a == A)
      form_chunk<M, GN, A>(op, rz, ga, gb, g, b, t, x0, c0, tid);
    else
      form_chunk_at<M, GN, A + 1>(a, op, rz, ga, gb, g, b, t, x0, c0, tid);
  }
}

// grid: ((C / 64) * ceil(CO / 128) * P, splits); part: (splits, P*3, C, CO)
// fp32. The pipeline of wgrad_wgmma_kernel; each chunk's products are the
// six piece products, one m64n192k16 wgmma each.
template <int M, bool GN>
__global__ void __launch_bounds__(384, 1)
wgrad_split_wgmma_kernel(const __grid_constant__ CUtensorMap tm_z,
                         const __grid_constant__ CUtensorMap tm_dy,
                         const float* __restrict__ ga, const float* __restrict__ gb,
                         float* __restrict__ part, Geom g) {
  using namespace hopper;
  using K = Cfg<M>;
  constexpr int P = K::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ops = align_1024(smem_raw);    // [OS][A | B]
  unsigned char* raws = ops + OS * K::OP_BYTES;  // [RS][z | dy chunk 0 | dy chunk 1]
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(raws + RS * K::RAW_BYTES);

  int bx = blockIdx.x;
  const int a = bx % P;
  bx /= P;
  const int n_cot = (g.CO + TNW - 1) / TNW;
  const int co0 = (bx % n_cot) * TNW, c0 = (bx / n_cot) * TC;
  const int s = blockIdx.y;
  const int k0 = (int)((long long)s * g.n_chunks / g.splits);
  const int nk = (int)((long long)(s + 1) * g.n_chunks / g.splits) - k0;
  const int tid = threadIdx.x;

  auto load_chunk = [&](int i) {  // thread 0: the raw rows of chunk i
    int b, t, x0;
    chunk_coords<KC>(g, k0 + i, &b, &t, &x0);
    unsigned char* dst = raws + (i % RS) * K::RAW_BYTES;
    uint64_t* bar = &raw_full[i % RS];
    mbar_expect_tx(bar, K::RAW_BYTES);
    tma_load_4d(dst, &tm_z, bar, c0, x0, M * t - 1, b);
    tma_load_4d(dst + K::Z_BYTES, &tm_dy, bar, co0, x0 - 1, M * t, b);
    tma_load_4d(dst + K::Z_BYTES + K::DY_BOX, &tm_dy, bar, co0 + 64, x0 - 1, M * t, b);
  };
  if (tid == 0) {
    for (int i = 0; i < RS; ++i) mbar_init(&raw_full[i], 1);
    mbar_fence_init();
    for (int i = 0; i < RS && i < nk; ++i) load_chunk(i);
  }
  __syncthreads();

  // warpgroup 0 (threads 0..127) only forms operands; warpgroups 1 and 2 also
  // multiply, w taking output channels co0 + 64 w .. + 63
  const int w = __shfl_sync(0xffffffffu, tid / 128, 0) - 1;  // warp-uniform for ptxas
  const int warp = (tid / 32) % 4, lane = tid % 32;
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  const uint32_t b_off = K::A_BYTES + (w < 0 ? 0 : w) * K::B_WG;
  for (int i = 0; i < nk; ++i) {
    // chunk i's operand pieces into stage i % OS, formed by every thread;
    // the products of chunk i - 2 read the stage last, and the consumers
    // waited for them before the previous barrier
    int b, t, x0;
    chunk_coords<KC>(g, k0 + i, &b, &t, &x0);
    mbar_wait(&raw_full[i % RS], (i / RS) & 1);
    form_chunk_at<M, GN>(a, ops + (i % OS) * K::OP_BYTES, raws + (i % RS) * K::RAW_BYTES, ga,
                         gb, g, b, t, x0, c0, tid);
    fence_proxy_async();
    if (w >= 0) {
      wgmma_wait<0>();  // chunk i - 1's products: stage (i + 1) % OS is free after the barrier
      fence_regs(acc);
    }
    __syncthreads();
    if (tid == 0 && i + RS < nk) load_chunk(i + RS);  // raw stage i % RS has been read
    if (w >= 0) {
      const uint32_t st = smem_u32(ops + (i % OS) * K::OP_BYTES);
      wgmma_fence();
#pragma unroll
      for (int o = 0; o < kSplitProducts; ++o)
        wgmma_ss_n192_tt(acc, desc_mnmajor(st + split_piece_a(o) * TILE, TILE),
                         desc_mnmajor(st + b_off + split_piece_b(o) * 3 * TILE, TILE));
      wgmma_commit();
    }
  }
  if (w < 0) return;
  wgmma_wait<0>();
  fence_regs(acc);
  if (co0 + 64 * w >= g.CO) return;  // CO % 128 == 64: this warpgroup's channels lie past CO
  // rows c0 + 16 warp + g (+ 8), columns n = 8 j + 2 tq (+ 1): dx = n / 64
  const int g8 = lane >> 2, tq = lane & 3;
  const size_t plane = (size_t)g.C * g.CO;
  float* base = part + ((size_t)s * P + a) * 3 * plane + (size_t)(c0 + 16 * warp + g8) * g.CO +
                co0 + 64 * w + 2 * tq;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    float* dst = base + (j / 8) * plane + 8 * (j % 8);
    *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(dst + 8 * g.CO) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int M, bool GN>
int launch(const void* z, const void* dy, const void* ga, const void* gb, void* part,
           const Geom& g, cudaStream_t stream) {
  using K = Cfg<M>;
  CUtensorMap tz, tdy;
  const uint64_t dz[4] = {(uint64_t)g.C, (uint64_t)g.W, (uint64_t)g.H, (uint64_t)g.B};
  const uint64_t ddy[4] = {(uint64_t)g.CO, (uint64_t)g.W, (uint64_t)g.H, (uint64_t)g.B};
  const uint32_t bz[4] = {64, KC, M + 2, 1};
  const uint32_t bdy[4] = {64, KC + 2, M, 1};
  int err = hopper::make_map_f32_nd(&tz, z, dz, bz);
  if (!err) err = hopper::make_map_f32_nd(&tdy, dy, ddy, bdy);
  if (err) return err;
  auto kernel = wgrad_split_wgmma_kernel<M, GN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.C / TC) * ((g.CO + TNW - 1) / TNW) * K::P, g.splits);
  kernel<<<grid, 384, K::SMEM, stream>>>(tz, tdy, static_cast<const float*>(ga),
                                         static_cast<const float*>(gb),
                                         static_cast<float*>(part), g);
  return (int)cudaGetLastError();
}

}  // namespace sp

template <int M, bool GN>
int launch(const void* z, const void* dy, const void* ga, const void* gb, void* part,
           void* out, const Geom& g, int dtype, cudaStream_t stream) {
  const int err = dtype == 1 ? wg::launch<M, GN>(z, dy, ga, gb, part, g, stream)
                             : sp::launch<M, GN>(z, dy, ga, gb, part, g, stream);
  if (err) return err;
  const size_t n = (size_t)(M + 2) * 3 * g.C * g.CO;
  fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, g.splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// z: (B, H, W, C) (raw x when gn); dy: (B, H, W, CO), both dtype (0 fp32,
// 1 bf16); ga, gb: (B, C) fp32 when gn, else unused; part: (splits, P*3, C,
// CO) fp32 scratch; out: (P*3, C, CO) fp32 with P = m + 2. The Python wrapper
// checks: contiguous, 16-byte aligned, C % 64 == 0, H % m == 0, and CO % 128
// == 0 (bf16) or CO % 64 == 0 (fp32); it picks `splits` (fp32: no block sums
// more than 4096 positions). Returns cudaGetLastError().
int gdt_conv3x3_wgrad(const void* z, const void* dy, const void* ga, const void* gb,
                      void* part, void* out, int B, int H, int W, int C, int CO, int m,
                      int gn, int splits, int dtype, void* stream) {
  const int kc = dtype == 1 ? wg::KC : sp::KC;  // positions per chunk
  const int ht = H / m, n_xc = (W + kc - 1) / kc;
  Geom g{B, H, W, C, CO, ht, n_xc, B * ht * n_xc, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (m == 2 && !gn) return launch<2, false>(z, dy, ga, gb, part, out, g, dtype, s);
  if (m == 2 && gn) return launch<2, true>(z, dy, ga, gb, part, out, g, dtype, s);
  if (m == 4 && !gn) return launch<4, false>(z, dy, ga, gb, part, out, g, dtype, s);
  if (m == 4 && gn) return launch<4, true>(z, dy, ga, gb, part, out, g, dtype, s);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
