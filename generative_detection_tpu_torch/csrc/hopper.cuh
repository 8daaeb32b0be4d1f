// Hopper (sm_90a) building blocks shared by the attention and convolution
// kernels: mbarriers, TMA copies, wgmma descriptors and instructions,
// register rebalancing, and the host-side tensor maps.
//
// Shared-memory tiles use the 128-byte swizzle that TMA writes and wgmma
// reads: a (rows, C) bf16 tile is stored as C / 64 column chunks, each
// (rows, 64) with 128-byte rows, chunk after chunk; 8 rows x 128 bytes form
// one swizzle atom (1024 bytes, 1024-byte aligned).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x, hidden from the compiler's analysis: a value it must recompute where it
// is used instead of keeping it live in a register across a loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// The first 1024-byte aligned address at or after p (the swizzle atom's alignment).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies completing on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier is
// in phase 0, so waiting on parity 1 returns at once (a ring's empty slots).
// A wait of more than about 2^34 cycles (~10 s) traps, so a broken pipeline
// surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// ---- copies -----------------------------------------------------------------

// TMA: the box at column x, row y of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// TMA: the box at coordinates (x0, x1, x2, x3) of a 4-D tensor map (x0 the
// innermost dimension) into shared memory. Coordinates may be negative or
// run past the tensor: those elements are filled with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x0, int x1, int x2, int x3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x0), "r"(x1), "r"(x2),
      "r"(x3)
      : "memory");
}

// TMA: the box at coordinates (x0, x1, x2) of a 3-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x0, int x1, int x2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x0), "r"(x1), "r"(x2)
      : "memory");
}

// TMA: a shared-memory tile to the box at (x0, x1, x2, x3) of a 4-D tensor
// map; elements outside the tensor are not written. Commit with
// bulk_commit(); bulk_wait_read() in the same thread waits until the tile
// has been read, so its shared memory may be written again.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int x0,
                                             int x1, int x2, int x3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(x0), "r"(x1), "r"(x2),
      "r"(x3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operand reads), before it signals the consumers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk copy of `bytes` contiguous bytes (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a K-major operand (rows of the contraction dimension
// contiguous) in the swizzled layout: 8-row groups 1024 bytes apart. A step
// of 16 along K inside a 64-column chunk adds 32 bytes to the address.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// Descriptor of a K-major operand without swizzle: 8-row x 16-byte core
// matrices, rows 16 bytes apart (so 8-row groups 128 bytes apart), the two
// 8-element halves of a K step of 16 `k_bytes` apart. The start may sit at
// any 16-byte boundary, so a shift of the operand by whole rows is a shift
// of the address.
__device__ __forceinline__ uint64_t desc_kmajor_plain(uint32_t addr, uint32_t k_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(k_bytes >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// Descriptor of an MN-major operand (the output dimension contiguous): the
// 64-wide column chunks `chunk_bytes` apart (leading offset), 8-row groups
// of the contraction dimension 1024 bytes apart (stride offset). A step of
// 16 along K adds 16 rows (2048 bytes) to the address.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t chunk_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(chunk_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers at this point of the program: the compiler may not move
// their reads or writes across it (around the asynchronous wgmma).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// An fp32 accumulator of m64nNk16 (N = 8 J) as the bf16 A fragments of the
// next product's K steps: thread (warp w, lane 4 g + t) holds rows 16 w + g
// and + 8 at columns 8 j + 2 t, + 1 in d[4 j .. 4 j + 3], and the A operand
// of K step k wants (row g, cols 16 k + 2 t), (row g + 8, same), (row g,
// cols 16 k + 8 + 2 t), (row g + 8, same).
template <int J>
__device__ __forceinline__ void acc_to_a(const float (&d)[4 * J], uint32_t (&a)[J / 2][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(d[4 * j], d[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// The pair (x, y) as the sum of NP packed bf16 pairs, each the pair nearest
// to what the earlier ones leave (that remainder is exact in fp32): one
// piece is the rounding acc_to_a does, two carry a value to about 2^-17 of
// its size, three to about 2^-25, below fp32's own rounding.
template <int NP>
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t (&w)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
    const float2 f = __bfloat1622float2(p);
    x -= f.x;
    y -= f.y;
  }
}

// The logits of keys at or past l_valid as -inf in an m64nBK accumulator sc
// (rows 16 warp + g and + 8, columns 8 j + 2 tq and + 1 of this thread),
// whose keys are its BK columns from k0 (KEY_COLS) or its 64 rows from k0.
// Only the tile that reaches past l_valid has any: elsewhere this is one
// uniform compare.
template <int BK, bool KEY_COLS>
__device__ __forceinline__ void mask_keys(float (&sc)[BK / 2], int k0, int l_valid, int warp,
                                          int g, int tq) {
  if (k0 + (KEY_COLS ? BK : 64) <= l_valid) return;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = KEY_COLS ? k0 + 8 * j + 2 * tq + (e & 1) : k0 + warp * 16 + g + 8 * (e / 2);
      if (key >= l_valid) sc[4 * j + e] = -INFINITY;
    }
}

// acc_to_a for an accumulator split into NP bf16 pieces: a[i] holds piece i
// as the A fragments of the next product's K steps.
template <int J, int NP>
__device__ __forceinline__ void acc_to_a_pieces(const float (&d)[4 * J],
                                                uint32_t (&a)[NP][J / 2][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[NP];
      split_bf16x2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], w);
#pragma unroll
      for (int i = 0; i < NP; ++i) a[i][j / 2][(j % 2) * 2 + h] = w[i];
    }
  }
}

// The split-precision pre-pass: x (n fp32 values, n % 8 == 0, 16-byte
// aligned) as NP bf16 pieces, piece p of element i at dst[p * n + i]; a
// grid-stride loop over the blocks of gridDim.x, 8 elements a thread.
template <int NP>
__device__ __forceinline__ void split_to_pieces(const float* __restrict__ x,
                                                __nv_bfloat16* __restrict__ dst, size_t n) {
  const size_t step = (size_t)gridDim.x * blockDim.x * 8;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8; i < n; i += step) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + i + 4));
    const float r[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t w[NP][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t t[NP];
      split_bf16x2(r[2 * e], r[2 * e + 1], t);
#pragma unroll
      for (int p = 0; p < NP; ++p) w[p][e] = t[p];
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<uint4*>(dst + p * n + i) = make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  }
}

// The six piece products (i, j), i + j <= 2, of two operands split into
// three pieces each (split_bf16x2), the small ones first: (2, 0), (0, 2),
// (1, 1), (1, 0), (0, 1), (0, 0). Product o multiplies piece
// split_piece_a(o) of the first operand by piece split_piece_b(o) of the
// second.
constexpr int kSplitProducts = 6;
__host__ __device__ constexpr int split_piece_a(int o) {
  constexpr int a[kSplitProducts] = {2, 0, 1, 1, 0, 0};
  return a[o];
}
__host__ __device__ constexpr int split_piece_b(int o) {
  constexpr int b[kSplitProducts] = {0, 2, 1, 0, 1, 0};
  return b[o];
}

template <int N, int M, int P>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M][P]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

// D (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), A and B bf16 in shared memory,
// both K-major (descriptors from desc_kmajor).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), A and B bf16 in shared
// memory, A K-major (desc_kmajor or desc_kmajor_plain), B MN-major
// (desc_mnmajor; the transpose bit of B is set).
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128), A and B bf16 in shared
// memory, A K-major (desc_kmajor or desc_kmajor_plain), B MN-major
// (desc_mnmajor: two 64-wide column chunks; the transpose bit of B is set).
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t da, uint64_t db,
                                            int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss_mn takes N = 64 or 128");
  if constexpr (N == 128) {
    wgmma_ss_n128_mn(d, da, db, accumulate);
  } else {
    wgmma_ss_n64_mn(d, da, db, accumulate);
  }
}

// D (64 x 32, fp32) (+)= A (64 x 16) B (16 x 32), A and B bf16 in shared memory,
// both K-major (descriptors from desc_kmajor).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma_ss takes N = 32 or 64");
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    wgmma_ss_n32(d, da, db, accumulate);
  }
}

// D (64 x 192, fp32) += A (64 x 16) B (16 x 192), A and B bf16 in shared
// memory, both MN-major (descriptors from desc_mnmajor; both transpose bits
// set): A is stored as K rows of 64 M-elements, B as three 64-wide N chunks
// of K rows.
__device__ __forceinline__ void wgmma_ss_n192_tt(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x 256),
// B bf16 in shared memory, MN-major (descriptor from desc_mnmajor; the
// transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n256_mn(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x 128),
// B bf16 in shared memory, MN-major (descriptor from desc_mnmajor; the
// transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x 64),
// B bf16 in shared memory, MN-major (one 128-byte column chunk; descriptor
// from desc_mnmajor; the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs_mn takes N = 64, 128 or 256");
  if constexpr (N == 256) {
    wgmma_rs_n256_mn(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128_mn(d, a, db);
  } else {
    wgmma_rs_n64_mn(d, a, db);
  }
}

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: fetched through the runtime, so
// the library needs no link against it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a row-major (rows, cols) bf16 matrix read in boxes of
// 64 columns (128 bytes, the swizzle span) by box_rows rows. Returns a CUDA
// error code (0 on success).
inline int make_map_bf16(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                         uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A tensor map over an R-D tensor of `elem_bytes`-byte elements of `type`
// with dims[0] innermost (contiguous), read or written in boxes of
// box[0..R-1] elements; elements outside the tensor read as zero (and are
// not written). With the 128-byte swizzle box[0] spans 128 bytes. Returns a
// CUDA error code (0 on success).
template <int R>
inline int make_map_nd(CUtensorMap* map, const void* ptr, const uint64_t (&dims)[R],
                       const uint32_t (&box)[R], CUtensorMapDataType type, uint64_t elem_bytes,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t d[R], strides[R - 1];
  cuuint32_t bx[R], elem_strides[R];
  uint64_t pitch = elem_bytes;
  for (int i = 0; i < R; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    elem_strides[i] = 1;
    if (i + 1 < R) strides[i] = pitch *= dims[i];
  }
  const CUresult r = fn(map, type, R, const_cast<void*>(ptr), d, strides, bx, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// make_map_nd over bf16 (with the 128-byte swizzle box[0] must be 64).
template <int R>
inline int make_map_bf16_nd(CUtensorMap* map, const void* ptr, const uint64_t (&dims)[R],
                            const uint32_t (&box)[R],
                            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  return make_map_nd(map, ptr, dims, box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, swizzle);
}

// make_map_nd over fp32, without swizzle.
template <int R>
inline int make_map_f32_nd(CUtensorMap* map, const void* ptr, const uint64_t (&dims)[R],
                           const uint32_t (&box)[R]) {
  return make_map_nd(map, ptr, dims, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
}

}  // namespace hopper
