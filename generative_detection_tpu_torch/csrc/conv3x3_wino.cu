// 3x3 stride-1 SAME convolution over NHWC for Hopper (sm_90a), in two row
// forms that share one pipeline, in bf16 and in fp32 on split precision:
//
//   row-Winograd F(2,3) (M = 2) and F(4,3) (M = 4), P = M + 2 points, with
//   U[a, dx] = sum_ky G[a, ky] K[ky, dx] computed outside (a torch op):
//     V_a[t]  = sum_u BT[a, u] z[M t + u - 1]      (fp32 sum; bf16: cast to bf16)
//     G_a     = sum_dx shift_dx(V_a) @ U[a, dx]    (fp32 accumulate)
//     out[M t + i] = sum_a AT[i, a] G_a + bias     (fp32; bf16: one rounding)
//   The same launch on dy with the rotated, io-swapped kernel is the dgrad.
//
//   direct, a tile's raw rows as the points:
//     out[y] = sum_{dy, dx} shift_dx(z[y + dy - 1]) @ K[dy, dx] + bias
//
// With `gn`, z = silu(x a + b) from the (B, C) fp32 affine, in fp32 (and
// rounded to bf16 in bf16); rows and columns outside the image are zero
// AFTER the activation. The direct form always takes the prologue and may
// also write z (`emit_z`, the training variant's saved activation).
//
// Replaces:
//   - generative_detection_tpu/ops/winograd_pallas.py `_wino_rows_pallas`
//     (kernel `_wino_rows_kernel`): wino_rows_wgmma_kernel<M, GN> in bf16,
//     wino_rows_split_wgmma_kernel<M, GN> in fp32;
//   - generative_detection_tpu/ops/fused_conv.py `_fused_pallas` (kernel
//     `_fused_kernel`), the direct form: fused_conv_wgmma_kernel<TT, PK,
//     EMIT_Z> in bf16, fused_conv_split_wgmma_kernel<PK, EMIT_Z> in fp32.
//
// Design (conv_rows<Form, GN, EMIT_Z>). A tile is ROWS image rows of TW
// columns by TN = 128 output channels, so the points and the prologue are
// formed once for 128 output channels: Winograd, M rows of 64 columns;
// direct, 4 accumulators of PK image rows of 64 / PK columns each (PK = 1;
// 2 or 4 where W is 32 or 16, which would leave half or three quarters of a
// 64-column tile empty). One persistent block per SM takes tiles in turn and
// runs their chunks of KC = 16 input channels as one sequence, so the loads
// of a tile's first chunks fly during the previous tile's last chunks and
// its epilogue:
//   - thread 0 keeps two chunks in flight by TMA, each stage paced by an
//     mbarrier: the raw rows (16 channels x TW + 2 columns from x0 - 1 x P
//     rows from ROWS t - 1, zero outside the tensor) into a ring of two, and
//     the weight slabs (U[a, dx] or K[dy, dx], 16 x 64, twice, 128-byte
//     swizzle) into another ring of two once the products that read the
//     stage are done;
//   - the 256 threads form the chunk's points from the raw rows (the
//     activation once per raw element) into a tile without swizzle: 16
//     bytes (8 channels) per column, so A = a point shifted by dx columns is
//     the same tile at an address 16 dx bytes on (wgmma's no-swizzle K-major
//     layout takes any 16-byte start; the 128-byte swizzle's 8-row atom
//     would not), formed in one round (4 channels of one column a thread,
//     the two halo columns one channel a lane of the last warp). Packed (PK
//     > 1), an accumulator's 64 positions run over PK rows, which the one
//     tile cannot give at a uniform stride past the halo columns: the points
//     go into three copies, copy dx shifted by dx columns, rows TW columns
//     apart, each activated element stored into the copies that hold it;
//   - two warpgroups run SS wgmma (A and B from shared memory, B MN-major)
//     and form the next chunk's points while they run. Winograd: 64 output
//     channels each, P * 3 m64n64k16 products into P fp32 accumulators, one
//     a point. Direct: two of the four accumulators each, over all 128
//     output channels; the 9 taps of an accumulator of rows r read point r +
//     dy at offset dx, all into its m64n128 accumulator, so each raw element
//     is activated (ROWS + 2) / ROWS times, not 3 times, and each operand
//     read from shared memory feeds 128 columns (at N = 64, the products
//     alone would take all of shared memory's 128 bytes a clock at the
//     tensor cores' peak).
// One barrier a chunk (a step, where the weights stream: fp32 Winograd
// below) orders it. A tile's first products start the sums
// (scale-d 0), so no instruction but wgmma writes the accumulators inside
// the pipeline. The epilogue applies AT (Winograd) and the bias in fp32 from
// the accumulators, stages the bf16 tile (128-byte swizzle) in the weight
// stage the last chunk read, or in a buffer of its own where it does not
// fit (direct), and writes it with TMA stores, which clip rows and columns
// past the image (any H and W). Every output element is written by one
// block: no atomics, and a repeat is bit-equal.
//
// fp32 (Direct<TT, PK, 3> and Wino<M, 3>, NP = 3 pieces): the tensor cores
// take bf16, so, as the fp32 attention does, every fp32 operand is three
// bf16 pieces (split_bf16x2: to about 2^-25 of its size) and every product
// the six piece products with i + j <= 2. split_weights_kernel writes the
// weights' pieces once a call (3 x S x C x CO bf16, S = 9 direct or 3 P
// Winograd: at most 14.2 MB, 32x32x512->256 at F(4,3)); the raw rows arrive
// as fp32 by TMA, V_a (Winograd) is summed in fp32 and each point is split
// into the three point tiles, so no pieces copy of the activation reaches
// HBM. A tile has 64 output channels (one m64n64k16 product a piece pair),
// the raw rows one stage (a chunk's products cover the next TMA), the
// points two (direct packed: one, three pieces of three shifted copies), and
// the output goes from the accumulators to HBM with masked float2 stores (an
// fp32 tile staged beside the weight pieces would not fit).
//   - Direct: a weight stage holds a chunk's three pieces (54 KB), two
//     stages, the six products small first; 213-226 KB.
//   - Winograd: a chunk's three pieces of 3 P slabs would take 108 KB at
//     F(4,3), too much for two stages beside the points, so the weights
//     stream one piece a stage through a ring of three (36 KB each at
//     F(4,3)): a chunk is three steps, weight piece 2, 1, 0, each with the
//     point pieces that pair with it. The weight piece a step streams sets
//     the order, (0,2); (1,1), (0,1); (2,0), (1,0), (0,0): small products
//     first within a step, not overall ((0,1) comes before (2,0)). A step's
//     load is issued two steps ahead.
//     The two warpgroups split the points (P / 2 accumulators of m64n64
//     each: 96 registers at F(4,3), where bf16's P of them take 192), so
//     out[i] = sum_a AT[i, a] G_a needs both: each warpgroup writes its
//     partial sums of the other's output rows to shared memory (the free
//     weight slot and point stage of the tile's last chunk), and each adds
//     them to its own; 139 / 208 KB (M = 2 / 4).
//
// Bound on the H100: the products, 2 * P * 3 * B * (H / M) * W * C * CO
// flops for Winograd (half the direct conv's at F(4,3)), 2 * 9 * B * H * W
// * C * CO for the direct form, six times that in fp32 on split precision.
// The Winograd form reads its weights from L2 once a chunk for each tile of
// 64 positions and 64 output channels: 32 bytes a clock an SM at the
// products' peak in fp32 (bf16, 128 output channels a tile: 64). What holds
// them back (inferred from
// ablations timed on the card, not read from a counter: ncu does not run on
// the card's machine): with the prologue, forming the points (two MUFU
// operations per activated raw element) beside the products rather than
// under them; the direct form without its formation or without its products
// ran in about two thirds of its full time each. Without the prologue, the
// chunk pipeline's fixed cost (waits and one barrier a chunk).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "hopper.cuh"
#include "winograd.cuh"

namespace {

constexpr int KC = 16;          // input channels per chunk
constexpr int TP = 64;          // output positions per accumulator (wgmma's M)
constexpr int kThreads = 256;   // two warpgroups
constexpr int kDirectRows = 4;  // accumulators a tile of the direct form

// A form says what the points are, how a tile is laid out (ROWS image rows of
// TW columns, read with COLS raw columns; PK image rows of TW = 64 / PK
// columns an accumulator), how the weights stream (a chunk in WSUB steps,
// each step's weight stage one of a ring of WSLOTS), how the two warpgroups
// split it (SPLIT_CO: 64 output channels each, every row; SPLIT_POINTS: half
// of the points each, every row and output channel; else half of the
// accumulator rows each, all 128 output channels), and which products feed each of a warpgroup's
// NACC accumulators of N = WG_N columns: accumulator n takes
// shift_dx(point(n, dy)) times slab(n, dy, dx) for dy < TAPS, dx < 3, and its
// accumulator row i (64 positions) is sum_n at(i, n) acc_n, for the
// warpgroup's WG_ROWS rows. Points 1 .. IN_ROWS - 1 lie inside the image
// whenever their tile does, so formation tests only the others.
//
// F(M,3): point a is V_a = sum_u BT[a, u] z_u; its accumulator G_a takes the
// products shift_dx(V_a) U[a, dx]; out[i] = sum_a AT[i, a] G_a. NP = 3 is
// the fp32 split-precision form: x and out fp32, every point and weight slab
// three bf16 pieces, 64 output channels a tile, the weights one piece a step
// (three steps a chunk, a ring of three stages), one raw stage, and the
// warpgroups split the points (accumulator n of warpgroup w is point w P / 2
// + n).
template <int M, int NP_ = 1>
struct Wino {
  using T = std::conditional_t<NP_ == 1, __nv_bfloat16, float>;
  static constexpr int NP = NP_, TN = NP == 1 ? 128 : 64, RS = NP == 1 ? 2 : 1, VS = 2;
  static constexpr int WSUB = NP, WSLOTS = NP == 1 ? 2 : 3;
  static constexpr int ROWS = M, P = M + 2, SLABS = 3 * P, TAPS = 1;
  static constexpr int PK = 1, TW = TP, COLS = TW + 2;
  static constexpr int IN_ROWS = P - 1;  // H % M == 0: only points 0 and P - 1 can fall outside
  static constexpr bool IDENTITY = false, SPLIT_CO = NP == 1, SPLIT_POINTS = NP != 1;
  static constexpr int WG_N = 64, WG_ROWS = M, NACC = NP == 1 ? P : P / 2;
  __device__ static constexpr float bt(int a, int u) { return bt_c(M, a, u); }
  __device__ static constexpr float at(int i, int n) { return at_c(M, i, n); }
  __device__ static constexpr int point(int n, int) { return n; }
  __device__ static constexpr int slab(int n, int, int dx) { return 3 * n + dx; }
};

// The direct form, TT accumulators of PK image rows each: point u is the
// activated raw row u; the accumulator of a warpgroup's row n takes the
// products shift_dx(z_{n PK + dy}) K[dy, dx] (points counted from the
// warpgroup's first row) over all TN output channels, so each operand read
// from shared memory feeds twice the columns of a 64-channel split (bf16).
// PK > 1 (W = 64 / PK: 32 or 16) packs PK image rows into an accumulator's
// 64 positions, where a 64-column tile would leave 1 - 1 / PK of them empty.
// NP = 3 is the fp32 split-precision form: x and out fp32, every point and
// weight slab three bf16 pieces, 64 output channels a tile (three weight
// pieces of 128 would not fit twice), one raw stage, and one point stage
// where packed (PK > 1: three pieces of three shifted copies).
template <int TT, int PK_, int NP_ = 1>
struct Direct {
  using T = std::conditional_t<NP_ == 1, __nv_bfloat16, float>;
  static constexpr int NP = NP_, TN = NP == 1 ? 128 : 64, RS = NP == 1 ? 2 : 1;
  static constexpr int VS = NP == 1 || PK_ == 1 ? 2 : 1, WSUB = 1, WSLOTS = 2;
  static constexpr int PK = PK_, TW = TP / PK, COLS = TW + 2;
  static constexpr int ROWS = TT * PK, P = ROWS + 2, SLABS = 9, TAPS = 3;
  static constexpr int IN_ROWS = 2;  // any H: points from 2 on can fall past the image
  static constexpr bool IDENTITY = true, SPLIT_CO = false, SPLIT_POINTS = false;
  static constexpr int WG_N = TN, WG_ROWS = TT / 2, NACC = TT / 2;
  static_assert(TT % 2 == 0, "the two warpgroups take half of the rows each");
  __device__ static constexpr float at(int i, int n) { return i == n ? 1.f : 0.f; }
  __device__ static constexpr int point(int n, int dy) { return n * PK + dy; }
  __device__ static constexpr int slab(int, int dy, int dx) { return 3 * dy + dx; }
};

template <class F>
struct Cfg {
  static constexpr int P = F::P, ESZ = sizeof(typename F::T);
  static constexpr uint32_t U_SLAB = KC * 128;            // a weight slab: 16 rows of 64 CO
  static constexpr int U_PIECES = F::NP / F::WSUB;         // weight pieces a stage
  static constexpr uint32_t U_HALF = U_PIECES * F::SLABS * U_SLAB;  // every slab (piece) for 64 CO
  static constexpr uint32_t U_BYTES = F::TN / 64 * U_HALF;  // a weight stage
  static constexpr uint32_t RAW_BYTES = P * F::COLS * KC * ESZ;  // [u][column][16 channels]
  // The point tile: [point][channel half][column][8 channels], so A shifted
  // by dx is the tile at 16 dx bytes on; or, packed (PK > 1), three copies
  // shifted by dx, each [channel half][point][column][8 channels], so an
  // accumulator's 64 positions over PK rows sit at the uniform 16-byte
  // stride that wgmma's no-swizzle A takes. V_PLANE apart: the two channel
  // halves (the descriptor's K step); V_ROW: points; V_DX: dx shifts.
  static constexpr bool PACKED = F::PK > 1;
  static constexpr uint32_t V_PLANE = PACKED ? P * F::TW * 16 : F::COLS * 16;
  static constexpr uint32_t V_ROW = PACKED ? F::TW * 16 : 2 * V_PLANE;
  static constexpr uint32_t V_DX = PACKED ? 2 * V_PLANE : 16;
  static constexpr uint32_t V_BYTES = PACKED ? 3 * 2 * V_PLANE : P * V_ROW;  // one piece
  static constexpr uint32_t V_STAGE = F::NP * V_BYTES;
  static constexpr uint32_t OUT_HALF = F::ROWS * F::TW * 128;  // [row][column][64 CO]
  // bf16: the output tile is staged in the weight stage the last chunk
  // read, or in a buffer of its own where it does not fit there, and
  // written by TMA; fp32 (NP = 3) writes it from the accumulators
  static constexpr bool TMA_OUT = F::NP == 1;
  static constexpr bool OUT_OWN = TMA_OUT && OUT_HALF > U_HALF;
  static constexpr uint32_t OUT_PITCH = OUT_OWN ? OUT_HALF : U_HALF;
  static constexpr uint32_t OUT_BYTES = OUT_OWN ? 2 * OUT_HALF : 0;
  static constexpr size_t SMEM = 1024 + F::WSLOTS * U_BYTES + F::RS * RAW_BYTES +
                                 F::VS * V_STAGE + OUT_BYTES + 8 * 8;
  static_assert(U_HALF % 1024 == 0 && RAW_BYTES % 128 == 0 && V_BYTES % 128 == 0, "align");
  static_assert(SMEM <= 232448, "shared memory");
};

struct Geom {
  int B, H, W, C, CO;
  int HT;       // row tiles per image: ceil(H / ROWS)
  int n_xt;     // column tiles per row tile: ceil(W / TW)
  int n_cot;    // output-channel tiles: CO / F::TN
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

// NCH values of type T at p, as floats
template <typename T, int NCH>
__device__ __forceinline__ void load_x(const unsigned char* p, float (&z)[NCH]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (NCH == 4) {
      const float4 r = *reinterpret_cast<const float4*>(p);
      z[0] = r.x; z[1] = r.y; z[2] = r.z; z[3] = r.w;
    } else {
      z[0] = *reinterpret_cast<const float*>(p);
    }
  } else {
    load_bf16<NCH>(p, z);
  }
}

// NCH floats at p as type T
template <typename T, int NCH>
__device__ __forceinline__ void store_x(T* p, const float (&v)[NCH]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (NCH == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      p[0] = v[0];
    }
  } else {
    store_bf16<NCH>(reinterpret_cast<unsigned char*>(p), v);
  }
}

// NCH floats at p as NP bf16 pieces (split_bf16x2), piece i at p + i *
// stride; with NP = 1 the one piece is the bf16 rounding (store_bf16)
template <int NP, int NCH>
__device__ __forceinline__ void store_pieces(unsigned char* p, const float (&v)[NCH],
                                             uint32_t stride) {
  if constexpr (NP == 1) {
    store_bf16<NCH>(p, v);
  } else if constexpr (NCH == 4) {
    uint32_t lo[NP], hi[NP];
    hopper::split_bf16x2(v[0], v[1], lo);
    hopper::split_bf16x2(v[2], v[3], hi);
#pragma unroll
    for (int i = 0; i < NP; ++i) *reinterpret_cast<uint2*>(p + i * stride) = make_uint2(lo[i], hi[i]);
  } else {
    float x = v[0];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      *reinterpret_cast<__nv_bfloat16*>(p + i * stride) = h;
      x -= __bfloat162float(h);
    }
  }
}

// The GroupNorm affine of NCH channels from offset off of the (B, C) arrays
template <int NCH>
__device__ __forceinline__ void load_affine(const float* __restrict__ ga,
                                            const float* __restrict__ gb, size_t off,
                                            float (&a)[NCH], float (&b)[NCH]) {
  if constexpr (NCH == 4) {
    const float4 a4 = *reinterpret_cast<const float4*>(ga + off);
    const float4 b4 = *reinterpret_cast<const float4*>(gb + off);
    a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
    b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
  } else {
    a[0] = ga[off];
    b[0] = gb[off];
  }
}

// z = silu(z a + b) in fp32 (z a + b rounded twice, as the plain version's
// product and sum), rounded to bf16 where T is
template <typename T, int NCH>
__device__ __forceinline__ void activate(float (&z)[NCH], const float (&a)[NCH],
                                         const float (&b)[NCH]) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const float w = __fadd_rn(__fmul_rn(z[j], a[j]), b[j]);
    z[j] = __fdividef(w, 1.f + __expf(-w));
  }
  if constexpr (std::is_same_v<T, float>) {
    return;
  } else if constexpr (NCH == 4) {  // rounded to bf16 two at a time
#pragma unroll
    for (int j = 0; j < NCH; j += 2) {
      const float2 r = __bfloat1622float2(__floats2bfloat162_rn(z[j], z[j + 1]));
      z[j] = r.x;
      z[j + 1] = r.y;
    }
  } else {
    z[0] = __bfloat162float(__float2bfloat16_rn(z[0]));
  }
}

// v += BT[A, U] z_U, skipped at compile time where the coefficient is zero
template <class F, int NCH, int A, int U>
__device__ __forceinline__ void add_term(float (&v)[NCH], const float (&z)[F::P][NCH]) {
  constexpr float cf = F::bt(A, U);
  if constexpr (cf != 0.f) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) v[j] = cf == 1.f ? v[j] + z[U][j] : fmaf(cf, z[U][j], v[j]);
  }
}

// Point A of the item's channels into the point tile: V_A summed in fp32,
// then rounded to bf16 once, or split into NP pieces
template <class F, int NCH, int A, int... U>
__device__ __forceinline__ void store_point(std::integer_sequence<int, U...>,
                                            const float (&z)[F::P][NCH], unsigned char* dst) {
  if constexpr (F::IDENTITY) {
    store_pieces<F::NP, NCH>(dst + A * Cfg<F>::V_ROW, z[A], Cfg<F>::V_BYTES);
  } else {
    float v[NCH];
#pragma unroll
    for (int j = 0; j < NCH; ++j) v[j] = 0.f;
    (add_term<F, NCH, A, U>(v, z), ...);
    store_pieces<F::NP, NCH>(dst + A * Cfg<F>::V_ROW, v, Cfg<F>::V_BYTES);
  }
}

template <class F, int NCH, int... A>
__device__ __forceinline__ void store_points(std::integer_sequence<int, A...>,
                                             const float (&z)[F::P][NCH], unsigned char* dst) {
  (store_point<F, NCH, A>(std::make_integer_sequence<int, F::P>{}, z, dst), ...);
}

// Every point for channels ch .. ch + NCH - 1 of the chunk at point column
// col (image column x0 - 1 + col): its raw rows (image rows y0 + u) are
// activated once (with GN) and combined into every point; rows and columns
// outside the image are zero. With EMIT_Z and zout, the activated body rows
// y0 + 1 .. y0 + ROWS of the body columns also go to zout.
template <class F, bool GN, bool EMIT_Z, int NCH>
__device__ __forceinline__ void form_item(unsigned char* vt, const unsigned char* raw,
                                          const float* __restrict__ ga,
                                          const float* __restrict__ gb,
                                          typename F::T* __restrict__ zout, const Geom& g, int b,
                                          int x0, int y0, int c0, int col, int ch) {
  using T = typename F::T;
  constexpr int P = F::P, ESZ = Cfg<F>::ESZ;
  const int xx = x0 - 1 + col;
  float z[P][NCH];
  if (xx >= 0 && xx < g.W) {
    float gav[NCH], gbv[NCH];
    if constexpr (GN) load_affine<NCH>(ga, gb, (size_t)b * g.C + c0 + ch, gav, gbv);
#pragma unroll
    for (int u = 0; u < P; ++u) {
      // a row outside the image: point 0 above it, or, from point IN_ROWS
      // on (known at compile time), a point past it
      if ((u == 0 && y0 < 0) || (u >= F::IN_ROWS && y0 + u >= g.H)) {
#pragma unroll
        for (int j = 0; j < NCH; ++j) z[u][j] = 0.f;
        continue;
      }
      load_x<T, NCH>(raw + (u * F::COLS + col) * (KC * ESZ) + ch * ESZ, z[u]);
      if constexpr (GN) activate<T, NCH>(z[u], gav, gbv);
    }
    if constexpr (EMIT_Z && NCH == 4) {  // NCH == 4: the body columns
      if (zout != nullptr) {
#pragma unroll
        for (int u = 1; u <= F::ROWS; ++u)
          if (y0 + u < g.H)
            store_x<T, NCH>(zout + (((size_t)b * g.H + y0 + u) * g.W + xx) * g.C + c0 + ch, z[u]);
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < P; ++u)
#pragma unroll
      for (int j = 0; j < NCH; ++j) z[u][j] = 0.f;
  }
  store_points<F, NCH>(std::make_integer_sequence<int, P>{}, z,
                       vt + (ch >> 3) * Cfg<F>::V_PLANE + col * 16 + (ch & 7) * 2);
}

// One chunk's point tile by the 256 threads. One copy: in one round, thread
// tid takes 4 channels of point column 1 + tid / 4 (image columns x0 .. x0 +
// 63), and the last warp also one channel a lane of the halo columns 0 and
// 65. Packed (the direct form, so with the prologue): items of (point, raw
// column, 4 channels), each activated once and stored into the copies that
// hold it, copy dx holding image column x0 + c + dx - 1 in its column c.
template <class F, bool GN, bool EMIT_Z>
__device__ __forceinline__ void form_chunk(unsigned char* vt, const unsigned char* raw,
                                           const float* __restrict__ ga,
                                           const float* __restrict__ gb,
                                           typename F::T* __restrict__ zout, const Geom& g, int b,
                                           int x0, int y0, int c0, int tid) {
  using K = Cfg<F>;
  using T = typename F::T;
  if constexpr (!K::PACKED) {
    static_assert(F::TW * 4 == kThreads, "one 4-channel item a thread");
    form_item<F, GN, EMIT_Z, 4>(vt, raw, ga, gb, zout, g, b, x0, y0, c0, 1 + (tid >> 2),
                                (tid & 3) * 4);
    if (tid >= kThreads - 32) {
      const int lane = tid & 31;
      form_item<F, GN, EMIT_Z, 1>(vt, raw, ga, gb, zout, g, b, x0, y0, c0,
                                  (lane >> 4) * (F::COLS - 1), lane & 15);
    }
  } else {
    static_assert(GN && F::IDENTITY, "packed: the direct form with the prologue");
    for (int it = tid; it < F::P * F::COLS * 4; it += kThreads) {
      const int ch = (it & 3) * 4, xr = (it >> 2) % F::COLS, u = (it >> 2) / F::COLS;
      const int y = y0 + u, xx = x0 - 1 + xr;
      float z[4] = {0.f, 0.f, 0.f, 0.f};
      if (y >= 0 && y < g.H && xx >= 0 && xx < g.W) {
        float a[4], bb[4];
        load_affine<4>(ga, gb, (size_t)b * g.C + c0 + ch, a, bb);
        load_x<T, 4>(raw + (u * F::COLS + xr) * (KC * K::ESZ) + ch * K::ESZ, z);
        activate<T, 4>(z, a, bb);
        if constexpr (EMIT_Z) {
          if (zout != nullptr && u >= 1 && u <= F::ROWS)
            store_x<T, 4>(zout + (((size_t)b * g.H + y) * g.W + xx) * g.C + c0 + ch, z);
        }
      }
      unsigned char* dst = vt + (ch >> 3) * K::V_PLANE + u * K::V_ROW + (ch & 7) * 2;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int c = xr - dx;
        if (c >= 0 && c < F::TW) store_pieces<F::NP, 4>(dst + dx * K::V_DX + c * 16, z, K::V_BYTES);
      }
    }
  }
}

struct Tile {
  int b, t, x0, co0;
};

// Tile number tl: output-channel tile fastest (the tiles that share raw rows
// run together), then column tile, row tile, image.
template <class F>
__device__ __forceinline__ Tile tile_at(const Geom& g, int tl) {
  Tile r;
  r.co0 = (tl % g.n_cot) * F::TN;
  tl /= g.n_cot;
  r.x0 = (tl % g.n_xt) * F::TW;
  tl /= g.n_xt;
  r.t = tl % g.HT;
  r.b = tl / g.HT;
  return r;
}

// Row i of the output transform over the NACC points from PT, for
// accumulator element e: sum_n AT[i, PT + n] acc[n][e] (zero coefficients
// skipped at compile time)
template <class F, int PT>
__device__ __forceinline__ float at_partial(const float (&acc)[F::NACC][F::WG_N / 2], int i,
                                            int e) {
  float v = 0.f;
#pragma unroll
  for (int n = 0; n < F::NACC; ++n) {
    const float cf = F::at(i, PT + n);
    if (cf == 1.f) {
      v += acc[n][e];
    } else if (cf != 0.f) {
      v = fmaf(cf, acc[n][e], v);
    }
  }
  return v;
}

// The body of the kernels. grid: min(n_tiles, SMs) persistent blocks of 256
// threads; block k takes tiles k, k + gridDim.x, ... and runs their chunks as
// one sequence q, each chunk in WSUB steps s = q WSUB + j (one weight stage
// each), so the loads of the next tile's first chunks fly during this tile's
// last ones and its epilogue. bf16 writes the output by TMA store (tm_out),
// fp32 from the accumulators (out).
template <class F, bool GN, bool EMIT_Z>
__device__ __forceinline__ void conv_rows(const CUtensorMap* tm_x, const CUtensorMap* tm_u,
                                          const CUtensorMap* tm_out,
                                          typename F::T* __restrict__ out,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ ga,
                                          const float* __restrict__ gb,
                                          typename F::T* __restrict__ zout, const Geom& g) {
  using namespace hopper;
  using K = Cfg<F>;
  constexpr int ROWS = F::ROWS, NP = F::NP, WSUB = F::WSUB, WSLOTS = F::WSLOTS;
  // piece products a tap and step: all six in one step, or at step j (weight
  // piece NP - 1 - j) the j + 1 point pieces that pair with it
  constexpr int NPROD = NP == 1 ? 1 : WSUB == 1 ? kSplitProducts : NP;
  static_assert((F::RS == 1 || F::RS == 2) && (F::VS == 1 || F::VS == 2), "stages");
  static_assert(WSUB == 1 || WSUB == NP, "a chunk in one step, or one weight piece a step");
  static_assert(WSLOTS == 2 || WSLOTS == 3, "weight stages");
  constexpr int RSH = F::RS == 2 ? 1 : 0;  // log2 of the raw stages
  extern __shared__ unsigned char smem_raw[];
  unsigned char* us = align_1024(smem_raw);        // [WSLOTS][weights half 0 | half 1]
  unsigned char* outs = us + WSLOTS * K::U_BYTES;  // the output tile's own buffer, if any
  unsigned char* raws = outs + K::OUT_BYTES;       // [RS][raw rows]
  unsigned char* vs = raws + F::RS * K::RAW_BYTES;  // [VS][piece][point tile]
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(vs + F::VS * K::V_STAGE);
  uint64_t* u_full = raw_full + 2;

  const int tid = threadIdx.x, nk = g.C / KC;
  const int n_mine = (g.n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int nq = n_mine * nk;  // chunk q: tile q / nk of this block, channels (q % nk) * KC
  const int ns = nq * WSUB;    // steps
  // step s's weight stage and the parity of its use
  auto slot_of = [](int s) { return WSLOTS == 2 ? s & 1 : s % WSLOTS; };
  auto phase_of = [](int s) { return (uint32_t)((WSLOTS == 2 ? s >> 1 : s / WSLOTS) & 1); };

  auto load_raw = [&](int q) {  // thread 0: chunk q's raw rows
    const Tile tt = tile_at<F>(g, blockIdx.x + (q / nk) * gridDim.x);
    uint64_t* bar = &raw_full[q & (F::RS - 1)];
    mbar_expect_tx(bar, K::RAW_BYTES);
    tma_load_4d(raws + (q & (F::RS - 1)) * K::RAW_BYTES, tm_x, bar, (q % nk) * KC, tt.x0 - 1,
                ROWS * tt.t - 1, tt.b);
  };
  // thread 0: step s's weights for both warpgroups: chunk s / WSUB's every
  // piece, or its piece NP - 1 - s % WSUB
  auto load_u = [&](int s) {
    const int q = s / WSUB, piece = WSUB == 1 ? 0 : NP - 1 - s % WSUB;
    const Tile tt = tile_at<F>(g, blockIdx.x + (q / nk) * gridDim.x);
    uint64_t* bar = &u_full[slot_of(s)];
    unsigned char* dst = us + slot_of(s) * K::U_BYTES;
    if constexpr (K::TMA_OUT && !K::OUT_OWN) bulk_wait_read();  // the previous tile's output has left the stage
    mbar_expect_tx(bar, K::U_BYTES);
#pragma unroll
    for (int h = 0; h < F::TN / 64; ++h)
      tma_load_3d(dst + h * K::U_HALF, tm_u, bar, tt.co0 + 64 * h, (q % nk) * KC,
                  piece * F::SLABS);
  };
  if (tid == 0) {
    for (int s = 0; s < 2 + WSLOTS; ++s) mbar_init(&raw_full[s], 1);
    mbar_fence_init();
    for (int s = 0; s < WSLOTS && s < ns; ++s) {
      if (s < F::RS) load_raw(s);
      load_u(s);
    }
  }
  __syncthreads();

  // warpgroup wg: output channels co0 + 64 wg .. + 63 of every row
  // (SPLIT_CO), points NACC wg .. + NACC - 1 (SPLIT_POINTS), or every output
  // channel of rows WG_ROWS wg .. + WG_ROWS - 1
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g8 = lane >> 2, tq = lane & 3;
  const int co_wg = F::SPLIT_CO ? 64 * wg : 0;
  const int row_wg = F::SPLIT_CO || F::SPLIT_POINTS ? 0 : F::WG_ROWS * wg;
  const int pt_wg = F::SPLIT_POINTS ? F::NACC * wg : 0;
  const uint32_t v_addr = smem_u32(vs) + (row_wg * F::PK + pt_wg) * K::V_ROW;
  const uint32_t u_addr = smem_u32(us) + (F::SPLIT_CO ? wg * K::U_HALF : 0) +
                          (F::SPLIT_POINTS ? F::slab(pt_wg, 0, 0) * K::U_SLAB : 0);
  float acc[F::NACC][F::WG_N / 2];  // each tile's first products overwrite it (scale-d 0)
#pragma unroll
  for (int n = 0; n < F::NACC; ++n)
#pragma unroll
    for (int e = 0; e < F::WG_N / 2; ++e) acc[n][e] = 0.f;
  for (int k = 0; k < n_mine; ++k) {
    const Tile tt = tile_at<F>(g, blockIdx.x + k * gridDim.x);
    typename F::T* zt = EMIT_Z && tt.co0 == 0 ? zout : nullptr;  // z from co tile 0 only
    for (int i = 0; i < nk; ++i) {
      const int q = k * nk + i;
#pragma unroll
      for (int j = 0; j < WSUB; ++j) {
        const int s = q * WSUB + j;
        if (j == 0) {
          if constexpr (F::VS == 1) {
            // one point stage: chunk q - 1's products read it, so every
            // thread waits for them before any overwrites it
            if (q > 0) {
              wgmma_wait<0>();
              fence_regs(acc);
              __syncthreads();
            }
          }
          // chunk q's points into stage q % VS: with two stages the products
          // of chunk q - 2 read it last, and every thread waited for them
          // before the previous barrier
          mbar_wait(&raw_full[q & (F::RS - 1)], (q >> RSH) & 1);
          form_chunk<F, GN, EMIT_Z>(vs + (q & (F::VS - 1)) * K::V_STAGE,
                                    raws + (q & (F::RS - 1)) * K::RAW_BYTES, ga, gb, zt, g, tt.b,
                                    tt.x0, ROWS * tt.t - 1, i * KC, tid);
          fence_proxy_async();
        }
        wgmma_wait<0>();  // step s - 1's products: its weight stage is free after the barrier
        fence_regs(acc);
        // the previous tile's output has left its own buffer before the epilogue
        if (K::OUT_OWN && tid == 0 && i == nk - 1) bulk_wait_read();
        __syncthreads();
        if (tid == 0) {
          if (j == 0 && q + F::RS < nq) load_raw(q + F::RS);  // raw stage q % RS has been read
          // weight stage (s - 1) % WSLOTS has been read
          if (s >= 1 && s + WSLOTS - 1 < ns) load_u(s + WSLOTS - 1);
        }
        mbar_wait(&u_full[slot_of(s)], phase_of(s));
        const uint32_t va = v_addr + (q & (F::VS - 1)) * K::V_STAGE;
        const uint32_t ua = u_addr + slot_of(s) * K::U_BYTES;
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < F::NACC; ++n)
#pragma unroll
          for (int dy = 0; dy < F::TAPS; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int o = 0; o < NPROD; ++o) {
                // fp32 in one step: the six piece products, small first; in
                // NP steps: point pieces j, j - 1, .. 0 by weight piece NP - 1 - j
                if (WSUB > 1 && o > j) continue;
                const int pa = NP == 1 ? 0 : WSUB == 1 ? split_piece_a(o) : j - o;
                const int pb = NP == 1 || WSUB > 1 ? 0 : split_piece_b(o);  // in the stage
                wgmma_ss_mn<F::WG_N>(
                    acc[n],
                    desc_kmajor_plain(
                        va + pa * K::V_BYTES + F::point(n, dy) * K::V_ROW + dx * K::V_DX,
                        K::V_PLANE),
                    desc_mnmajor(ua + (pb * F::SLABS + F::slab(n, dy, dx)) * K::U_SLAB,
                                 K::U_HALF),  // 64-col chunks
                    // the tile's first product starts the sum
                    i > 0 || j > 0 || dy > 0 || dx > 0 || o > 0);
              }
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    if constexpr (K::TMA_OUT) {
      // out[ROWS t + row_wg + i, x0 + r, co] = sum_n at(i, n) acc_n + bias
      // for the accumulator's rows r = 16 warp + g8 (+ 8) and columns co =
      // co0 + co_wg + 8 j + 2 tq (+ 1), staged per 64 output channels as
      // [row][r][64 co] (128-byte swizzle: unit j of row R at j ^ (R mod 8))
      // in the output's buffer or in the weight stage the last chunk read
      // (its next load waits for the store), then written by TMA, which
      // clips rows and columns past the image
      unsigned char* obase = K::OUT_OWN ? outs : us + ((k * nk + nk - 1) & 1) * K::U_BYTES;
      unsigned char* owg = obase + (F::SPLIT_CO ? wg * K::OUT_PITCH : 0);
#pragma unroll
      for (int j = 0; j < F::WG_N / 8; ++j) {
        const float2 bj =
            *reinterpret_cast<const float2*>(bias + tt.co0 + co_wg + 8 * j + 2 * tq);
        unsigned char* ot = owg + (F::SPLIT_CO ? 0 : (j >> 3) * K::OUT_PITCH);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g8 + 8 * h;
#pragma unroll
          for (int i = 0; i < F::WG_ROWS; ++i) {
            float v0 = 0.f, v1 = 0.f;
#pragma unroll
            for (int n = 0; n < F::NACC; ++n) {
              const float cf = F::at(i, n);
              if (cf == 1.f) {
                v0 += acc[n][4 * j + 2 * h];
                v1 += acc[n][4 * j + 2 * h + 1];
              } else if (cf != 0.f) {
                v0 = fmaf(cf, acc[n][4 * j + 2 * h], v0);
                v1 = fmaf(cf, acc[n][4 * j + 2 * h + 1], v1);
              }
            }
            const int R = (row_wg + i) * TP + r;
            *reinterpret_cast<uint32_t*>(ot + R * 128 + (((j & 7) ^ (R & 7)) << 4) + tq * 4) =
                pack_bf16(v0 + bj.x, v1 + bj.y);
          }
        }
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        for (int w = 0; w < F::TN / 64; ++w)
          tma_store_4d(tm_out, obase + w * K::OUT_PITCH, tt.co0 + 64 * w, tt.x0, ROWS * tt.t,
                       tt.b);
        bulk_commit();
      }
    } else if constexpr (F::SPLIT_POINTS) {
      // fp32 Winograd: warpgroup w holds G_a of points pt .. pt + NACC - 1 (pt
      // = NACC w) and writes output rows HALF w .. + HALF - 1 of its tile.
      // Each sends its partial sums sum_a AT[i, a] G_a of the other's rows
      // through shared memory, as [row][element][thread] floats: to warpgroup
      // 0 in the weight stage the tile's last step read, to warpgroup 1 in
      // the point stage its last chunk read. Both are free once both
      // warpgroups' products are done, and nothing writes either before the
      // next step's barrier. out = own partial + the other's + bias, at
      // column x0 + r (rows and columns past the image are not written).
      constexpr int HALF = ROWS / 2, XBYTES = HALF * 32 * 128 * 4;
      static_assert(2 * F::NACC == F::P && F::WG_N == 64, "two halves of the points");
      static_assert(XBYTES <= K::U_BYTES && XBYTES <= K::V_STAGE, "exchange buffers");
      const int q_last = k * nk + nk - 1;
      float* xch[2] = {
          reinterpret_cast<float*>(us + slot_of(q_last * WSUB + WSUB - 1) * K::U_BYTES),
          reinterpret_cast<float*>(vs + (q_last & (F::VS - 1)) * K::V_STAGE)};
      const int t = tid & 127;
      auto partial = [&](auto w, int i, int e) {
        return at_partial<F, F::NACC * decltype(w)::value>(acc, i, e);
      };
      auto send = [&](auto w) {
        constexpr int other = 1 - decltype(w)::value;
        float* dst = xch[other] + t;
#pragma unroll
        for (int i = 0; i < HALF; ++i)
#pragma unroll
          for (int e = 0; e < 32; ++e) dst[(i * 32 + e) * 128] = partial(w, other * HALF + i, e);
      };
      auto finish = [&](auto w) {
        constexpr int wv = decltype(w)::value;
        const float* src = xch[wv] + t;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const int y = ROWS * tt.t + wv * HALF + i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int co = tt.co0 + 8 * j + 2 * tq;
            const float2 bj = *reinterpret_cast<const float2*>(bias + co);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int x = tt.x0 + 16 * warp + g8 + 8 * h, e = 4 * j + 2 * h;
              const float v0 = partial(w, wv * HALF + i, e) + src[(i * 32 + e) * 128];
              const float v1 = partial(w, wv * HALF + i, e + 1) + src[(i * 32 + e + 1) * 128];
              if (y < g.H && x < g.W)
                *reinterpret_cast<float2*>(out + (((size_t)tt.b * g.H + y) * g.W + x) * g.CO +
                                           co) = make_float2(v0 + bj.x, v1 + bj.y);
            }
          }
        }
      };
      using W0 = std::integral_constant<int, 0>;
      using W1 = std::integral_constant<int, 1>;
      __syncthreads();  // both warpgroups' products are done
      if (wg == 0) send(W0{}); else send(W1{});
      __syncthreads();
      if (wg == 0) finish(W0{}); else finish(W1{});
      fence_proxy_async();  // before the weight stage's next TMA load
    } else {
      // fp32 (the direct form): out = acc + bias at image row ROWS t + (row_wg
      // + i) PK + r / TW, column x0 + r % TW, written from the accumulators
      // (an fp32 tile staged beside three weight pieces would not fit);
      // rows and columns past the image are not written
      static_assert(F::IDENTITY, "fp32 runs the direct form");
#pragma unroll
      for (int j = 0; j < F::WG_N / 8; ++j) {
        const int co = tt.co0 + 8 * j + 2 * tq;
        const float2 bj = *reinterpret_cast<const float2*>(bias + co);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g8 + 8 * h, x = tt.x0 + r % F::TW;
#pragma unroll
          for (int i = 0; i < F::WG_ROWS; ++i) {
            const int y = ROWS * tt.t + (row_wg + i) * F::PK + r / F::TW;
            if (y < g.H && x < g.W)
              *reinterpret_cast<float2*>(out + (((size_t)tt.b * g.H + y) * g.W + x) * g.CO + co) =
                  make_float2(acc[i][4 * j + 2 * h] + bj.x, acc[i][4 * j + 2 * h + 1] + bj.y);
          }
        }
      }
    }
  }
  if constexpr (K::TMA_OUT) {
    if (tid == 0) bulk_wait_read();  // the last tile's output has left shared memory
  }
}

// B7: the row-Winograd forward (and, on dy, the dgrad)
template <int M, bool GN>
__global__ void __launch_bounds__(kThreads, 1)
wino_rows_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_u,
                       const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ bias,
                       const float* __restrict__ ga, const float* __restrict__ gb,
                       __nv_bfloat16* __restrict__, Geom g) {
  conv_rows<Wino<M>, GN, false>(&tm_x, &tm_u, &tm_out, nullptr, bias, ga, gb, nullptr, g);
}

// B7 in fp32: the row-Winograd forward (and, on dy, the dgrad) on split
// precision (tm_u over the weight pieces of split_weights_kernel)
template <int M, bool GN>
__global__ void __launch_bounds__(kThreads, 1)
wino_rows_split_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_u, float* __restrict__ out,
                             const float* __restrict__ bias, const float* __restrict__ ga,
                             const float* __restrict__ gb, float* __restrict__, Geom g) {
  conv_rows<Wino<M, 3>, GN, false>(&tm_x, &tm_u, nullptr, out, bias, ga, gb, nullptr, g);
}

// B6: the direct conv with the GroupNorm+SiLU prologue
template <int TT, int PK, bool EMIT_Z>
__global__ void __launch_bounds__(kThreads, 1)
fused_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_u,
                        const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ bias,
                        const float* __restrict__ ga, const float* __restrict__ gb,
                        __nv_bfloat16* __restrict__ zout, Geom g) {
  conv_rows<Direct<TT, PK>, true, EMIT_Z>(&tm_x, &tm_u, &tm_out, nullptr, bias, ga, gb, zout,
                                          g);
}

// B6 in fp32: the direct form on split precision (tm_u over the weight
// pieces of split_weights_kernel)
template <int PK, bool EMIT_Z>
__global__ void __launch_bounds__(kThreads, 1)
fused_conv_split_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_u, float* __restrict__ out,
                              const float* __restrict__ bias, const float* __restrict__ ga,
                              const float* __restrict__ gb, float* __restrict__ zout, Geom g) {
  conv_rows<Direct<kDirectRows, PK, 3>, true, EMIT_Z>(&tm_x, &tm_u, nullptr, out, bias, ga, gb,
                                                      zout, g);
}

// The fp32 weight slabs (n = S C CO values: K, S = 9, or U, S = 3 P) as
// three bf16 pieces, piece p of element i at pieces[p n + i]: the (3 S, C,
// CO) slabs tm_u reads.
__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ pieces, size_t n) {
  hopper::split_to_pieces<3>(w, pieces, n);
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

// u: the bf16 weight slabs (S, C, CO), or for fp32 (NP = 3) their pieces
// (3 S, C, CO)
template <class F, typename Kernel>
int launch(Kernel kernel, const void* x, const void* u, const void* bias, const void* ga,
           const void* gb, void* out, void* zout, int B, int H, int W, int C, int CO,
           cudaStream_t stream) {
  using K = Cfg<F>;
  using T = typename F::T;
  const int ht = (H + F::ROWS - 1) / F::ROWS, n_xt = (W + F::TW - 1) / F::TW;
  const int n_cot = CO / F::TN;
  const Geom g{B, H, W, C, CO, ht, n_xt, n_cot, B * ht * n_xt * n_cot};
  CUtensorMap tx, tu, to;
  const uint64_t dx[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint32_t bx[4] = {KC, F::COLS, F::P, 1};
  const uint64_t du[3] = {(uint64_t)CO, (uint64_t)C, (uint64_t)(F::NP * F::SLABS)};
  const uint32_t bu[3] = {64, KC, K::U_PIECES * F::SLABS};  // a weight stage's slabs
  int err = F::NP == 1 ? hopper::make_map_bf16_nd(&tx, x, dx, bx)
                       : hopper::make_map_f32_nd(&tx, x, dx, bx);
  if (!err) err = hopper::make_map_bf16_nd(&tu, u, du, bu, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err && K::TMA_OUT) {
    const uint64_t dout[4] = {(uint64_t)CO, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint32_t bout[4] = {64, F::TW, F::ROWS, 1};
    err = hopper::make_map_bf16_nd(&to, out, dout, bout, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err) return err;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = g.n_tiles < sm_count() ? g.n_tiles : sm_count();
  const float* fb = static_cast<const float*>(bias);
  const float* fa = static_cast<const float*>(ga);
  const float* fg = static_cast<const float*>(gb);
  if constexpr (K::TMA_OUT)
    kernel<<<grid, kThreads, K::SMEM, stream>>>(tx, tu, to, fb, fa, fg, static_cast<T*>(zout), g);
  else
    kernel<<<grid, kThreads, K::SMEM, stream>>>(tx, tu, static_cast<T*>(out), fb, fa, fg,
                                                static_cast<T*>(zout), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, C) in dtype (1 bf16, 0 fp32); u: (S, C, CO) in dtype, the
// weight slabs: mode 1 (the direct form, gn required) K[dy, dx] at dy * 3 +
// dx, S = 9; mode 2 or 4 the row-Winograd U[a, dx] at a * 3 + dx, S = (mode
// + 2) * 3; bias: (CO,) fp32; ga, gb: (B, C) fp32 GroupNorm affine when gn,
// else unused; out: (B, H, W, CO) in dtype; zout: (B, H, W, C) in dtype when
// emit_z (mode 1 only); pieces: fp32 only, (3, S, C, CO) bf16 scratch for
// the weight pieces. The Python wrapper checks the rest: contiguous, 16-byte
// aligned, C % 16 == 0, CO % 128 == 0 (bf16) or CO % 64 == 0 (fp32), H %
// mode == 0. Returns cudaGetLastError().
int gdt_conv3x3_wino(const void* x, const void* u, const void* bias, const void* ga,
                     const void* gb, void* out, void* zout, void* pieces, int B, int H, int W,
                     int C, int CO, int m, int gn, int emit_z, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto form, auto kernel, const void* w) {
    return launch<decltype(form)>(kernel, x, w, bias, ga, gb, out, zout, B, H, W, C, CO, st);
  };
  constexpr int TT = kDirectRows;
  if (dtype == 0) {  // fp32: split precision, after the weights' pieces
    if (pieces == nullptr || (m == 1 && !gn) || (m != 1 && emit_z) || (m != 1 && m != 2 && m != 4))
      return (int)cudaErrorInvalidValue;
    const size_t n = (size_t)(m == 1 ? 9 : 3 * (m + 2)) * C * CO;
    const int blocks = (int)((n / 8 + 255) / 256 < 1056 ? (n / 8 + 255) / 256 : 1056);
    split_weights_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(u),
                                                 static_cast<__nv_bfloat16*>(pieces), n);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    if (m == 2)
      return gn ? run(Wino<2, 3>{}, wino_rows_split_wgmma_kernel<2, true>, pieces)
                : run(Wino<2, 3>{}, wino_rows_split_wgmma_kernel<2, false>, pieces);
    if (m == 4)
      return gn ? run(Wino<4, 3>{}, wino_rows_split_wgmma_kernel<4, true>, pieces)
                : run(Wino<4, 3>{}, wino_rows_split_wgmma_kernel<4, false>, pieces);
    if (W == TP / 2)
      return emit_z ? run(Direct<TT, 2, 3>{}, fused_conv_split_wgmma_kernel<2, true>, pieces)
                    : run(Direct<TT, 2, 3>{}, fused_conv_split_wgmma_kernel<2, false>, pieces);
    if (W == TP / 4)
      return emit_z ? run(Direct<TT, 4, 3>{}, fused_conv_split_wgmma_kernel<4, true>, pieces)
                    : run(Direct<TT, 4, 3>{}, fused_conv_split_wgmma_kernel<4, false>, pieces);
    return emit_z ? run(Direct<TT, 1, 3>{}, fused_conv_split_wgmma_kernel<1, true>, pieces)
                  : run(Direct<TT, 1, 3>{}, fused_conv_split_wgmma_kernel<1, false>, pieces);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (m == 1 && gn) {  // PK image rows an accumulator where W = 64 / PK (32 or 16)
    if (W == TP / 2)
      return emit_z ? run(Direct<TT, 2>{}, fused_conv_wgmma_kernel<TT, 2, true>, u)
                    : run(Direct<TT, 2>{}, fused_conv_wgmma_kernel<TT, 2, false>, u);
    if (W == TP / 4)
      return emit_z ? run(Direct<TT, 4>{}, fused_conv_wgmma_kernel<TT, 4, true>, u)
                    : run(Direct<TT, 4>{}, fused_conv_wgmma_kernel<TT, 4, false>, u);
    return emit_z ? run(Direct<TT, 1>{}, fused_conv_wgmma_kernel<TT, 1, true>, u)
                  : run(Direct<TT, 1>{}, fused_conv_wgmma_kernel<TT, 1, false>, u);
  }
  if (emit_z) return (int)cudaErrorInvalidValue;
  if (m == 2)
    return gn ? run(Wino<2>{}, wino_rows_wgmma_kernel<2, true>, u)
              : run(Wino<2>{}, wino_rows_wgmma_kernel<2, false>, u);
  if (m == 4)
    return gn ? run(Wino<4>{}, wino_rows_wgmma_kernel<4, true>, u)
              : run(Wino<4>{}, wino_rows_wgmma_kernel<4, false>, u);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
