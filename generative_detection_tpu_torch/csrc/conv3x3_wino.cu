// Row-Winograd 3x3 stride-1 SAME convolution over NHWC in bf16, with an
// optional GroupNorm+SiLU prologue, for Hopper (sm_90a):
//
//   V_a[t]  = sum_u BT[a, u] z[M t + u - 1]      (fp32 sum, cast to bf16)
//   G_a     = sum_dx shift_dx(V_a) @ U[a, dx]    (fp32 accumulate)
//   out[M t + i] = sum_a AT[i, a] G_a + bias     (fp32, one rounding to bf16)
//
// for F(2,3) (M = 2) and F(4,3) (M = 4), P = M + 2 points, with U[a, dx] =
// sum_ky G[a, ky] K[ky, dx] computed outside (a torch op). With `gn`, z =
// silu(x a + b) from the (B, C) fp32 affine, in fp32 and rounded to bf16;
// rows and columns outside the image are zero AFTER the activation. The same
// launch on dy with the rotated, io-swapped kernel is the dgrad.
//
// Replaces generative_detection_tpu/ops/winograd_pallas.py
// `_wino_rows_pallas` (kernel `_wino_rows_kernel`) in bf16; fp32 keeps the
// FMA kernel of conv3x3.cu.
//
// Design (wino_rows_wgmma_kernel<M, GN>). A tile is TP = 64 output
// positions (columns x0 .. x0 + 63 of one t-row: M output rows) by TN = 128
// output channels, so V_a and the prologue are formed once for 128 output
// channels. One persistent block per SM takes tiles in turn and runs their
// chunks of KC = 16 input channels as one sequence, so the loads of a tile's
// first chunks fly during the previous tile's last chunks and its epilogue:
//   - thread 0 keeps two chunks in flight by TMA, each stage paced by an
//     mbarrier: the raw rows (16 channels x 66 columns from x0 - 1 x P rows
//     from M t - 1, zero outside the tensor) into a ring of two, and U[:, :,
//     chunk, co tile] (P * 3 slabs of 16 x 64, twice, 128-byte swizzle)
//     into another ring of two once the products that read the stage are done;
//   - the 256 threads form the chunk's V_a for every point from the raw
//     rows in one round (4 channels of one column a thread, the two halo
//     columns one channel a lane of the last warp; the activation once per
//     raw element) into a tile without swizzle: 16 bytes (8 channels) per
//     column, so A = V_a shifted by dx columns is the same tile at an
//     address 16 dx bytes on (wgmma's no-swizzle K-major layout takes any
//     16-byte start; the 128-byte swizzle's 8-row atom would not);
//   - two warpgroups, 64 output channels each, run P * 3 m64n64k16 wgmma
//     (A and B from shared memory, B MN-major) into P fp32 accumulators (P *
//     32 registers a thread) and form the next chunk's V while they run.
// One barrier a chunk orders it. A tile's first products start the sums
// (scale-d 0), so no instruction but wgmma writes the accumulators inside
// the pipeline. The epilogue applies AT and the bias in fp32 from the
// accumulators, stages the bf16 tile in the U stage the last chunk read
// (128-byte swizzle) and writes it with TMA stores, which clip columns past
// the image; the stage's next load waits until they have read it. Every
// output element is written by one block: no atomics, and a repeat is
// bit-equal.
//
// Bound on the H100: the products, 2 * P * 3 * B * (H / M) * W * C * CO
// flops (half the direct conv's at F(4,3)). What holds it back (inferred
// from ablations timed on the card, not read from a counter: ncu does not
// run on the card's machine): with the prologue, forming V (two MUFU
// operations per activated raw element, each raw row activated for the
// (M + 2) / M t-rows that read it); without it, the chunk pipeline's fixed
// cost (waits and one barrier a chunk). Reloading U from L2 for every tile
// costs little: a kernel that skipped it was no faster.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

#include "hopper.cuh"
#include "winograd.cuh"

namespace {

constexpr int KC = 16;         // input channels per chunk
constexpr int TP = 64;         // output positions per block (columns of one t-row)
constexpr int COLS = TP + 2;   // V columns: x0 - 1 .. x0 + TP
constexpr int TN = 128;        // output channels per block, 64 per warpgroup
constexpr int kThreads = 256;  // two warpgroups

template <int M>
struct Cfg {
  static constexpr int P = M + 2;
  static constexpr uint32_t U_SLAB = KC * 128;        // U[a, dx]: 16 rows of 64 CO (128 B)
  static constexpr uint32_t U_HALF = P * 3 * U_SLAB;  // every (a, dx) for 64 CO
  static constexpr uint32_t U_BYTES = 2 * U_HALF;
  static constexpr uint32_t RAW_BYTES = P * COLS * KC * 2;  // [u][column][16 channels]
  static constexpr uint32_t V_PLANE = COLS * 16;            // 8 channels of every column
  static constexpr uint32_t V_POINT = 2 * V_PLANE;
  static constexpr uint32_t V_BYTES = P * V_POINT;  // [a][channel half][column][8 channels]
  static constexpr uint32_t OUT_HALF = M * TP * 128;  // a warpgroup's [i][column][64 CO]
  static constexpr size_t SMEM = 1024 + 2 * (U_BYTES + RAW_BYTES + V_BYTES) + 4 * 8;
  static_assert(U_HALF % 1024 == 0 && RAW_BYTES % 128 == 0 && V_BYTES % 128 == 0, "align");
  static_assert(OUT_HALF <= U_HALF, "a warpgroup's output tile fits its half of a U stage");
  static_assert(SMEM <= 232448, "shared memory");
};

struct Geom {
  int B, H, W, C, CO;
  int HT;       // t-rows per image: H / M
  int n_xt;     // column tiles per t-row: ceil(W / TP)
  int n_cot;    // output-channel tiles: CO / TN
  int n_tiles;  // B * HT * n_xt * n_cot
};

// NCH bf16 values at p, as floats
template <int NCH>
__device__ __forceinline__ void load_bf16(const unsigned char* p, float (&z)[NCH]) {
  if constexpr (NCH == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 z01 = __bfloat1622float2(h[0]), z23 = __bfloat1622float2(h[1]);
    z[0] = z01.x; z[1] = z01.y; z[2] = z23.x; z[3] = z23.y;
  } else {
    z[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
}

// NCH floats rounded to bf16 at p
template <int NCH>
__device__ __forceinline__ void store_bf16(unsigned char* p, const float (&v)[NCH]) {
  if constexpr (NCH == 4) {
    uint2 out;
    out.x = hopper::pack_bf16(v[0], v[1]);
    out.y = hopper::pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = out;
  } else {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v[0]);
  }
}

// v += BT[A, U] z_U, skipped at compile time where the coefficient is zero
template <int M, int NCH, int A, int U>
__device__ __forceinline__ void add_term(float (&v)[NCH], const float (&z)[M + 2][NCH]) {
  constexpr float cf = bt_c(M, A, U);
  if constexpr (cf != 0.f) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) v[j] = cf == 1.f ? v[j] + z[U][j] : fmaf(cf, z[U][j], v[j]);
  }
}

// V_A of the item's channels into the V tile (rounded to bf16 once)
template <int M, int NCH, int A, int... U>
__device__ __forceinline__ void store_point(std::integer_sequence<int, U...>,
                                            const float (&z)[M + 2][NCH], unsigned char* dst) {
  float v[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j) v[j] = 0.f;
  (add_term<M, NCH, A, U>(v, z), ...);
  store_bf16<NCH>(dst + A * Cfg<M>::V_POINT, v);
}

template <int M, int NCH, int... A>
__device__ __forceinline__ void store_points(std::integer_sequence<int, A...>,
                                             const float (&z)[M + 2][NCH], unsigned char* dst) {
  (store_point<M, NCH, A>(std::make_integer_sequence<int, M + 2>{}, z, dst), ...);
}

// V_a of every point for channels ch .. ch + NCH - 1 of the chunk at V column
// col (image column x0 - 1 + col): its raw rows are activated once (with GN)
// and combined into every point; rows and columns outside the image are zero.
template <int M, bool GN, int NCH>
__device__ __forceinline__ void form_item(unsigned char* vt, const unsigned char* raw,
                                          const float* __restrict__ ga,
                                          const float* __restrict__ gb, const Geom& g, int b,
                                          int x0, int c0, bool first, bool last, int col,
                                          int ch) {
  constexpr int P = M + 2;
  const int xx = x0 - 1 + col;
  float z[P][NCH];
  if (xx >= 0 && xx < g.W) {
    float gav[NCH], gbv[NCH];
    if constexpr (GN) {
      const size_t off = (size_t)b * g.C + c0 + ch;
      if constexpr (NCH == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(ga + off);
        const float4 b4 = *reinterpret_cast<const float4*>(gb + off);
        gav[0] = a4.x; gav[1] = a4.y; gav[2] = a4.z; gav[3] = a4.w;
        gbv[0] = b4.x; gbv[1] = b4.y; gbv[2] = b4.z; gbv[3] = b4.w;
      } else {
        gav[0] = ga[off];
        gbv[0] = gb[off];
      }
    }
#pragma unroll
    for (int u = 0; u < P; ++u) {
      if ((u == 0 && first) || (u == P - 1 && last)) {  // a row outside the image
#pragma unroll
        for (int j = 0; j < NCH; ++j) z[u][j] = 0.f;
        continue;
      }
      load_bf16<NCH>(raw + (u * COLS + col) * (KC * 2) + ch * 2, z[u]);
      if constexpr (GN) {
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          // x a + b rounded twice, as the plain version's product and sum
          const float w = __fadd_rn(__fmul_rn(z[u][j], gav[j]), gbv[j]);
          z[u][j] = __fdividef(w, 1.f + __expf(-w));
        }
        if constexpr (NCH == 4) {  // the activation rounded to bf16, two at a time
#pragma unroll
          for (int j = 0; j < NCH; j += 2) {
            const float2 r = __bfloat1622float2(__floats2bfloat162_rn(z[u][j], z[u][j + 1]));
            z[u][j] = r.x;
            z[u][j + 1] = r.y;
          }
        } else {
          z[u][0] = __bfloat162float(__float2bfloat16_rn(z[u][0]));
        }
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < P; ++u)
#pragma unroll
      for (int j = 0; j < NCH; ++j) z[u][j] = 0.f;
  }
  store_points<M, NCH>(std::make_integer_sequence<int, P>{}, z,
                       vt + (ch >> 3) * Cfg<M>::V_PLANE + col * 16 + (ch & 7) * 2);
}

// One chunk's V tile, every point, by the 256 threads in one round: thread
// tid takes 4 channels of V column 1 + tid / 4 (image columns x0 .. x0 + 63),
// and the last warp also one channel a lane of the halo columns 0 and 65.
template <int M, bool GN>
__device__ __forceinline__ void form_chunk(unsigned char* vt, const unsigned char* raw,
                                           const float* __restrict__ ga,
                                           const float* __restrict__ gb, const Geom& g, int b,
                                           int x0, int c0, bool first, bool last, int tid) {
  static_assert(TP * 4 == kThreads, "one 4-channel item a thread");
  form_item<M, GN, 4>(vt, raw, ga, gb, g, b, x0, c0, first, last, 1 + (tid >> 2), (tid & 3) * 4);
  if (tid >= kThreads - 32) {
    const int lane = tid & 31;
    form_item<M, GN, 1>(vt, raw, ga, gb, g, b, x0, c0, first, last, (lane >> 4) * (COLS - 1),
                        lane & 15);
  }
}

struct Tile {
  int b, t, x0, co0;
};

// Tile number tl: output-channel tile fastest (the tiles that share raw rows
// run together), then column tile, t-row, image.
__device__ __forceinline__ Tile tile_at(const Geom& g, int tl) {
  Tile r;
  r.co0 = (tl % g.n_cot) * TN;
  tl /= g.n_cot;
  r.x0 = (tl % g.n_xt) * TP;
  tl /= g.n_xt;
  r.t = tl % g.HT;
  r.b = tl / g.HT;
  return r;
}

// grid: min(n_tiles, SMs) persistent blocks of 256 threads; block k takes
// tiles k, k + gridDim.x, ... and runs their chunks as one sequence q, so the
// loads of the next tile's first chunks fly during this tile's last ones and
// its epilogue
template <int M, bool GN>
__global__ void __launch_bounds__(kThreads, 1)
wino_rows_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_u,
                       const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ bias,
                       const float* __restrict__ ga, const float* __restrict__ gb, Geom g) {
  using namespace hopper;
  using K = Cfg<M>;
  constexpr int P = K::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* us = align_1024(smem_raw);        // [2][U half 0 | U half 1]
  unsigned char* raws = us + 2 * K::U_BYTES;       // [2][raw rows]
  unsigned char* vs = raws + 2 * K::RAW_BYTES;     // [2][V tile]
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(vs + 2 * K::V_BYTES);
  uint64_t* u_full = raw_full + 2;

  const int tid = threadIdx.x, nk = g.C / KC;
  const int n_mine = (g.n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int nq = n_mine * nk;  // chunk q: tile q / nk of this block, channels (q % nk) * KC

  auto load_raw = [&](int q) {  // thread 0: chunk q's raw rows
    const Tile tt = tile_at(g, blockIdx.x + (q / nk) * gridDim.x);
    uint64_t* bar = &raw_full[q & 1];
    mbar_expect_tx(bar, K::RAW_BYTES);
    tma_load_4d(raws + (q & 1) * K::RAW_BYTES, &tm_x, bar, (q % nk) * KC, tt.x0 - 1,
                M * tt.t - 1, tt.b);
  };
  auto load_u = [&](int q) {  // thread 0: chunk q's U for both warpgroups
    const Tile tt = tile_at(g, blockIdx.x + (q / nk) * gridDim.x);
    uint64_t* bar = &u_full[q & 1];
    unsigned char* dst = us + (q & 1) * K::U_BYTES;
    bulk_wait_read();  // the previous tile's output has left the stage
    mbar_expect_tx(bar, K::U_BYTES);
    tma_load_3d(dst, &tm_u, bar, tt.co0, (q % nk) * KC, 0);
    tma_load_3d(dst + K::U_HALF, &tm_u, bar, tt.co0 + 64, (q % nk) * KC, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < 4; ++s) mbar_init(&raw_full[s], 1);
    mbar_fence_init();
    for (int q = 0; q < 2 && q < nq; ++q) {
      load_raw(q);
      load_u(q);
    }
  }
  __syncthreads();

  const int wg = tid >> 7;  // output channels co0 + 64 wg .. + 63
  const int warp = (tid >> 5) & 3, lane = tid & 31, g8 = lane >> 2, tq = lane & 3;
  const uint32_t v_addr = smem_u32(vs), u_addr = smem_u32(us) + wg * K::U_HALF;
  float acc[P][32];  // each tile's first products overwrite it (scale-d 0)
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[a][e] = 0.f;
  for (int k = 0; k < n_mine; ++k) {
    const Tile tt = tile_at(g, blockIdx.x + k * gridDim.x);
    const bool first = tt.t == 0, last = tt.t == g.HT - 1;
    for (int i = 0; i < nk; ++i) {
      const int q = k * nk + i, s = q & 1;
      const uint32_t phase = (q >> 1) & 1;
      // chunk q's V into stage s: the products of chunk q - 2 read it last,
      // and every thread waited for them before the previous barrier
      mbar_wait(&raw_full[s], phase);
      form_chunk<M, GN>(vs + s * K::V_BYTES, raws + s * K::RAW_BYTES, ga, gb, g, tt.b, tt.x0,
                        i * KC, first, last, tid);
      fence_proxy_async();
      wgmma_wait<0>();  // chunk q - 1's products: its U stage is free after the barrier
      fence_regs(acc);
      __syncthreads();
      if (tid == 0) {
        if (q + 2 < nq) load_raw(q + 2);          // raw stage s has been read
        if (q >= 1 && q + 1 < nq) load_u(q + 1);  // U stage (q + 1) % 2 has been read
      }
      mbar_wait(&u_full[s], phase);
      const uint32_t va = v_addr + s * K::V_BYTES, ua = u_addr + s * K::U_BYTES;
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < P; ++a)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          wgmma_ss_n64_mn(acc[a], desc_kmajor_plain(va + a * K::V_POINT + dx * 16, K::V_PLANE),
                          desc_mnmajor(ua + (a * 3 + dx) * K::U_SLAB, K::U_SLAB),
                          i > 0 || dx > 0);  // the tile's first product starts the sum
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // out[M t + i, x0 + r, co] = sum_a AT[i, a] G_a + bias for the
    // accumulator's rows r = 16 warp + g8 (+ 8) and columns co = co0 + 64 wg
    // + 8 j + 2 tq (+ 1), staged as [i][r][64 co] (128-byte swizzle: unit j
    // of row R at j ^ (R mod 8)) in the warpgroup's half of the U stage the
    // last chunk read (its next load waits for the store), then written by
    // TMA, which clips columns past the image
    unsigned char* ot = us + ((k * nk + nk - 1) & 1) * K::U_BYTES + wg * K::U_HALF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bias + tt.co0 + 64 * wg + 8 * j + 2 * tq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g8 + 8 * h;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          float v0 = 0.f, v1 = 0.f;
#pragma unroll
          for (int a = 0; a < P; ++a) {
            const float cf = at_c(M, i, a);
            if (cf != 0.f) {
              v0 = fmaf(cf, acc[a][4 * j + 2 * h], v0);
              v1 = fmaf(cf, acc[a][4 * j + 2 * h + 1], v1);
            }
          }
          const int R = i * TP + r;
          *reinterpret_cast<uint32_t*>(ot + R * 128 + ((j ^ (R & 7)) << 4) + tq * 4) =
              pack_bf16(v0 + bj.x, v1 + bj.y);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      for (int w = 0; w < 2; ++w)
        tma_store_4d(&tm_out, ot - wg * K::U_HALF + w * K::U_HALF, tt.co0 + 64 * w, tt.x0,
                     M * tt.t, tt.b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read();  // the last tile's output has left shared memory
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int M, bool GN>
int launch(const void* x, const void* u, const void* bias, const void* ga, const void* gb,
           void* out, const Geom& g, cudaStream_t stream) {
  using K = Cfg<M>;
  CUtensorMap tx, tu, to;
  const uint64_t dx[4] = {(uint64_t)g.C, (uint64_t)g.W, (uint64_t)g.H, (uint64_t)g.B};
  const uint32_t bx[4] = {KC, COLS, M + 2, 1};
  const uint64_t du[3] = {(uint64_t)g.CO, (uint64_t)g.C, (uint64_t)(M + 2) * 3};
  const uint32_t bu[3] = {64, KC, (M + 2) * 3};
  int err = hopper::make_map_bf16_nd(&tx, x, dx, bx);
  const uint64_t dout[4] = {(uint64_t)g.CO, (uint64_t)g.W, (uint64_t)g.H, (uint64_t)g.B};
  const uint32_t bout[4] = {64, TP, M, 1};
  if (!err) err = hopper::make_map_bf16_nd(&tu, u, du, bu, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = hopper::make_map_bf16_nd(&to, out, dout, bout, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto kernel = wino_rows_wgmma_kernel<M, GN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = g.n_tiles < sm_count() ? g.n_tiles : sm_count();
  kernel<<<grid, kThreads, K::SMEM, stream>>>(tx, tu, to, static_cast<const float*>(bias),
                                              static_cast<const float*>(ga),
                                              static_cast<const float*>(gb), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, C) bf16; u: ((m+2)*3, C, CO) bf16, the row-Winograd U[a, dx];
// bias: (CO,) fp32; ga, gb: (B, C) fp32 GroupNorm affine when gn, else
// unused; out: (B, H, W, CO) bf16. The Python wrapper checks the rest:
// contiguous, 16-byte aligned, C % 16 == 0, CO % 128 == 0, H % m == 0.
// Returns cudaGetLastError().
int gdt_conv3x3_wino(const void* x, const void* u, const void* bias, const void* ga,
                     const void* gb, void* out, int B, int H, int W, int C, int CO, int m,
                     int gn, void* stream) {
  const int ht = H / m, n_xt = (W + TP - 1) / TP;
  Geom g{B, H, W, C, CO, ht, n_xt, CO / TN, B * ht * n_xt * (CO / TN)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 2 && !gn) return launch<2, false>(x, u, bias, ga, gb, out, g, s);
  if (m == 2 && gn) return launch<2, true>(x, u, bias, ga, gb, out, g, s);
  if (m == 4 && !gn) return launch<4, false>(x, u, bias, ga, gb, out, g, s);
  if (m == 4 && gn) return launch<4, true>(x, u, bias, ga, gb, out, g, s);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
