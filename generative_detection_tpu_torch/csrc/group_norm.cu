// GroupNorm(G, eps) + optional SiLU over NHWC rows, for Hopper (sm_90a).
//
// Replaces generative_detection_tpu/ops/norm.py `_gn_pallas` (kernel
// `_gn_kernel`) and the chunked stats / apply kernels that take larger rows.
// The TPU kernel holds one image's whole (H*W, C) row in VMEM and makes one
// HBM round trip. A Hopper block has at most 227 KB of shared memory, so one
// block cannot hold a row of this model (up to 256*256*128 elements), but the
// blocks of the whole card can (132 x 3 x 75 KB).
//
// Bound on the H100: memory. The function must read x once and write y once
// (2 bytes per element each in bf16): 0.080 ms at 8x256x256x128 bf16.
//
// gn_fwd_resident_kernel (every row whose unit fits grid tiles):
//
//   * Units. GroupNorm's statistics are per (image, group), so a unit is an
//     image's rows over a slice of `cs` channels holding whole groups (128
//     bytes of a row: 64 bf16 or 32 fp32 channels). A unit is cut into
//     `tiles` row tiles of at most ~75 KB, and the slots (unit, tile) are
//     dealt to a persistent grid of one block per SM in order: block k takes
//     slots k, k + grid, k + 2 grid, ... (its rounds).
//   * Each block keeps a ring of three tiles in shared memory: round r
//     waiting for its unit's statistics, round r + 1 reduced, round r + 2 in
//     flight (cp.async, each thread copying the 16 bytes it later reduces and
//     normalizes). So x crosses HBM once: y is computed from the tile in
//     shared memory.
//   * A tile's per-group (sum, sumsq), reduced in a fixed order (rows in a
//     thread, a butterfly of warp shuffles, warps in order), goes to its slot
//     in `slot_tags` as 64-bit words that carry the launch's epoch beside the
//     value: one single-copy-atomic store, no fence, no counter.
//   * Before it normalizes round r, a block gathers round r's unit: it loads
//     the unit's tagged words (issued before it reduces round r + 1, so their
//     latency hides), re-reads any that do not yet carry this epoch, and
//     folds them tile by tile in order. Every block of a unit folds the same
//     words in the same order, so all derive the same mean and rstd, and
//     repeats are bit-equal. Atomics: only each block's exit count.
//   * Invariant: no block waits on a tile that a waiting block still has to
//     load. A block tags round r + 1 before it waits on round r; a unit has
//     at most grid tiles (the wrapper's rule), so its slots span at most two
//     consecutive rounds, all tagged before any block waits on the first;
//     the launch is cooperative, so every block is resident. A wait of more
//     than ~10 s traps instead of hanging the card.
//   * The epoch lives on the card ([epoch, exits], kept by the wrapper with
//     the tag buffer): every block reads it at entry and the last block out
//     advances it, so a replayed launch tags with a new epoch too.
//
// The affine entry (gdt_group_norm_affine), the prologue of the fused
// convolutions (`_gn_affine` of generative_detection_tpu/ops/fused_conv.py,
// XLA there), only reduces x: it reads x once in the stats pass (four rows
// of 16-byte loads a thread in flight where a thread walks at least
// kDeepRows rows) and folds the partials into the
// per-(image, channel) affine a = rstd * gamma, b = beta - mean * a in a
// small second launch. The resident kernel holds tiles for a reuse that the
// affine does not have; as its stats pass it was slower at most sites.
//
// The resident kernel writes the statistics for the backward
// (csrc/group_norm_bwd.cu) in its (B, tiles_bwd, 2, G) layout: an image's
// folded (sum, sumsq) in tile 0 and zeros in the other tiles, whose fold
// adds nothing, so the backward derives the same mean and rstd as the
// forward used. The stats pass writes its per-tile partials there.
//
// gn_stats_kernel + gn_apply_kernel (two launches) take the forward's other
// rows: rows too long for the card (a unit of more than grid tiles, an
// image of more than ~78K rows of 128 bytes) and groups whose C / G is
// not a power of two (a group would split a 16-byte vector). The stats pass
// writes per-tile partials to partial[b][tile][2][G]; the second pass folds
// them and, in the forward, reads x again.
//
// The variance is clamped at >= 0 (as `_gn_reference` does, norm.py:54); the
// TPU kernel does not clamp (norm.py:90). The one-pass E[x^2] - E[x]^2 can
// go slightly negative for a constant group, and rsqrt of a negative number
// would give NaN. y = x * (rstd * gamma) + (beta - mean * rstd * gamma), one
// FMA. The SiLU is t * sigmoid(t) by `__expf` and `__fdividef` in both
// dtypes (`silu` below).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // the two-pass kernels
constexpr int kResThreads = 512;  // the resident kernel
// The resident kernel's ring (tiles a block holds) and lag (rounds reduced
// ahead of the one that waits); the wrapper's `_RING` and `_LAG` match them.
constexpr int kRing = 3;
constexpr int kLag = 1;
constexpr int kGather = 12;       // tagged words a thread loads ahead
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on the H100
// The stats pass keeps four rows a thread in flight where a thread walks at
// least this many rows; below that (a few trips) the loop of one load a trip
// is as fast at the model's sites.
constexpr int kDeepRows = 12;

template <typename T> struct VecTraits;
template <> struct VecTraits<float> { static constexpr int N = 4; };
template <> struct VecTraits<__nv_bfloat16> { static constexpr int N = 8; };

// 16 bytes of a row, loaded raw and unpacked to fp32 where they are used.
template <typename T> __device__ __forceinline__ uint4 load_raw(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <typename T> __device__ __forceinline__ void unpack(uint4 u, float* out);
template <> __device__ __forceinline__ void unpack<float>(uint4 u, float* out) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 u, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 16-byte vector load of N elements, widened to fp32.
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

// SiLU, t * sigmoid(t) from the fast exp and the fast divide in both dtypes
// (relative error ~1e-6, growing with |t| as `__expf`'s does). `__frcp_rn`
// branches to a slow path that the compiler keeps per element (it made the
// resident kernel slower than the two launches it replaces), and the
// hardware tanh loses the tail, where 1 + tanh(t/2) cancels for t < -4.
__device__ __forceinline__ float silu(float t) { return __fdividef(t, 1.f + __expf(-t)); }

// ---- the two-pass kernels (rows too long for the card) ----------------------

// Thread layout shared by both passes: `lanes` = C / N threads cover one row
// with N channels each; the block walks `rpi` = kThreads / lanes rows at a time.
template <typename T, bool DEEP>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int L, int C,
                int G, int rows_per_tile, int tiles) {
  constexpr int N = VecTraits<T>::N;
  extern __shared__ float smem[];  // [2][rpi][C]
  const int tile = blockIdx.x, b = blockIdx.y;
  const int lanes = C / N, rpi = kThreads / lanes;
  const int lane = threadIdx.x % lanes, ri = threadIdx.x / lanes;
  const int row0 = tile * rows_per_tile;
  const int row1 = min(row0 + rows_per_tile, L);

  float s[N], ss[N];
#pragma unroll
  for (int j = 0; j < N; ++j) { s[j] = 0.f; ss[j] = 0.f; }
  if (ri < rpi) {
    const T* base = x + (size_t)b * L * C + lane * N;
    int r = row0 + ri;
    for (; DEEP && r + 3 * rpi < row1; r += 4 * rpi) {  // four 16-byte loads in flight
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) raw[u] = load_raw(base + (size_t)(r + u * rpi) * C);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[N];
        unpack<T>(raw[u], v);
#pragma unroll
        for (int j = 0; j < N; ++j) { s[j] += v[j]; ss[j] += v[j] * v[j]; }
      }
    }
    for (; r < row1; r += rpi) {
      float v[N];
      load_vec(base + (size_t)r * C, v);
#pragma unroll
      for (int j = 0; j < N; ++j) { s[j] += v[j]; ss[j] += v[j] * v[j]; }
    }
    float* s_sum = smem + ri * C + lane * N;
    float* s_sq = smem + rpi * C + ri * C + lane * N;
#pragma unroll
    for (int j = 0; j < N; ++j) { s_sum[j] = s[j]; s_sq[j] = ss[j]; }
  }
  __syncthreads();

  // Fold (row slot, channel) partials into groups, in a fixed order.
  const int cg = C / G;
  for (int k = threadIdx.x; k < 2 * G; k += kThreads) {
    const int which = k / G, g = k % G;
    const float* src = smem + which * rpi * C + g * cg;
    float acc = 0.f;
    for (int r = 0; r < rpi; ++r)
      for (int c = 0; c < cg; ++c) acc += src[r * C + c];
    partial[(((size_t)b * tiles + tile) * 2 + which) * G + g] = acc;
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                T* __restrict__ y, int L, int C, int G, int rows_per_tile, int tiles,
                float eps) {
  constexpr int N = VecTraits<T>::N;
  extern __shared__ float smem[];  // [2][G]: mean, rstd
  const int tile = blockIdx.x, b = blockIdx.y;
  float* s_mean = smem;
  float* s_rstd = smem + G;
  const float denom = (float)L * (float)(C / G);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.f, ss = 0.f;
    const float* p = partial + (size_t)b * tiles * 2 * G + g;
    for (int t = 0; t < tiles; ++t) {
      s += p[(2 * t) * G];
      ss += p[(2 * t + 1) * G];
    }
    const float mean = s / denom;
    const float var = fmaxf(ss / denom - mean * mean, 0.f);
    s_mean[g] = mean;
    s_rstd[g] = rsqrtf(var + eps);
  }
  __syncthreads();

  const int lanes = C / N, rpi = kThreads / lanes;
  const int lane = threadIdx.x % lanes, ri = threadIdx.x / lanes;
  if (ri >= rpi) return;
  const int cg = C / G;
  float m[N], r[N], ga[N], be[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = lane * N + j;
    m[j] = s_mean[c / cg];
    r[j] = s_rstd[c / cg];
    ga[j] = gamma[c];
    be[j] = beta[c];
  }
  const int row0 = tile * rows_per_tile;
  const int row1 = min(row0 + rows_per_tile, L);
  const size_t off = (size_t)b * L * C + lane * N;
  for (int row = row0 + ri; row < row1; row += rpi) {
    float v[N];
    load_vec(x + off + (size_t)row * C, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float t = (v[j] - m[j]) * r[j];
      t = t * ga[j] + be[j];
      if (SILU) t = silu(t);
      v[j] = t;
    }
    store_vec(y + off + (size_t)row * C, v);
  }
}

// Block b folds image b's stats partials (in gn_apply's order) into the
// per-channel affine a, b, each (B, C) fp32.
__global__ void __launch_bounds__(kThreads)
gn_affine_kernel(const float* __restrict__ partial, const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ a,
                 float* __restrict__ b, int L, int C, int G, int tiles, float eps) {
  extern __shared__ float smem[];  // [2][G]: mean, rstd
  const int img = blockIdx.x;
  const float denom = (float)L * (float)(C / G);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.f, ss = 0.f;
    const float* p = partial + (size_t)img * tiles * 2 * G + g;
    for (int t = 0; t < tiles; ++t) {
      s += p[(2 * t) * G];
      ss += p[(2 * t + 1) * G];
    }
    const float mean = s / denom;
    const float var = fmaxf(ss / denom - mean * mean, 0.f);
    smem[g] = mean;
    smem[G + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float av = smem[G + c / cg] * gamma[c];
    a[(size_t)img * C + c] = av;
    b[(size_t)img * C + c] = beta[c] - smem[c / cg] * av;
  }
}

// The stats pass over (tiles, B) blocks, its loop picked by the rows a thread walks.
template <typename T>
cudaError_t launch_stats(const void* x, void* partial, int B, int L, int C, int G,
                         int rows_per_tile, int tiles, cudaStream_t stream) {
  const int rpi = kThreads / (C / VecTraits<T>::N);
  auto stats = rows_per_tile >= kDeepRows * rpi ? gn_stats_kernel<T, true>
                                                : gn_stats_kernel<T, false>;
  stats<<<dim3(tiles, B), kThreads, 2 * rpi * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), L, C, G, rows_per_tile, tiles);
  return cudaGetLastError();
}

template <typename T>
int launch_two_pass(const void* x, const void* gamma, const void* beta, void* y,
                    void* partial, int B, int L, int C, int G, int rows_per_tile, int tiles,
                    float eps, int silu, cudaStream_t stream) {
  dim3 grid(tiles, B);
  cudaError_t err = launch_stats<T>(x, partial, B, L, C, G, rows_per_tile, tiles, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t apply_smem = 2 * G * sizeof(float);
  auto apply = silu ? gn_apply_kernel<T, true> : gn_apply_kernel<T, false>;
  apply<<<grid, kThreads, apply_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(partial),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<T*>(y), L,
      C, G, rows_per_tile, tiles, eps);
  return (int)cudaGetLastError();
}

// ---- the resident kernel ------------------------------------------------------

struct ResidentParams {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;                 // (B, L, C)
  float* partial;          // (B, tiles_bwd, 2, G): the backward's statistics
  unsigned long long* slot_tags;  // (B * C / cs * tiles, 2m): tagged group sums (tiles > 1)
  int* state;              // [epoch, blocks exited]: zero-initialized, kept by the wrapper
  int B, L, C, G, cs, tiles, tile_rows, tiles_bwd;
  float eps;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
// A value and the launch's epoch in one 64-bit word: a single-copy-atomic
// store, so a reader that sees the epoch sees the value (no fence needed).
__device__ __forceinline__ void st_tagged(unsigned long long* p, float v, unsigned epoch) {
  const unsigned long long w = ((unsigned long long)epoch << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long ld_tagged(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// The shared memory of one resident block (the wrapper's `_resident_smem`
// computes the same): the ring of tiles, each warp's group sums, and the
// statistics of each ring slot's unit.
__host__ __device__ inline size_t resident_smem(int cs, int tile_rows, int m, int elem) {
  return (size_t)kRing * tile_rows * cs * elem + (size_t)(kResThreads / 32) * 2 * m * 4 +
         (size_t)kRing * 2 * m * 4 + (size_t)(2 * m > kResThreads ? 2 * m : kResThreads) * 4;
}

template <typename Tx, bool SILU>
__global__ void __launch_bounds__(kResThreads, 1)
gn_fwd_resident_kernel(const ResidentParams p) {
  constexpr int N = VecTraits<Tx>::N;
  constexpr int W = kResThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // vr (16-byte vectors a row) is a power of two <= 32; a thread's N channels
  // hold whole groups (cg <= N) or a slice of one (cg > N, vpg vectors a group)
  const int cs = p.cs, vr = cs / N, rp = kResThreads / vr;
  const int v = threadIdx.x % vr, rs = threadIdx.x / vr;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int S = p.C / cs, cg = p.C / p.G, m = cs / cg, T = p.tiles;
  const int gt = cg <= N ? N / cg : 1, vpg = cg > N ? cg / N : 1;  // powers of two
  const int tile_elems = p.tile_rows * cs;
  const int slots = p.B * S * T;  // < 2^31 (the wrapper's rule)
  const int nr = (slots - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  Tx* ring = reinterpret_cast<Tx*>(smem_raw);
  float* wsum = reinterpret_cast<float*>(smem_raw + (size_t)kRing * tile_elems * sizeof(Tx));
  float* stats = wsum + W * 2 * m;  // [kRing][2m]: sums, then mean and rstd
  float* fold = stats + kRing * 2 * m;  // [max(512, 2m)]
  const Tx* x = static_cast<const Tx*>(p.x);
  if (nr <= 0) return;  // the wrapper's grid has a slot for every block
  const unsigned epoch = 1u + (unsigned)*reinterpret_cast<volatile int*>(p.state);
  const float denom = (float)p.L * (float)cg;

  // Slot of round r: unit u = (image b, slice s), tile t, rows [row0, row0 + rows).
  struct Slot { int q, u, b, s, t, row0, rows; };
  auto slot = [&](int r) {
    Slot o;
    o.q = blockIdx.x + r * gridDim.x;
    o.u = (unsigned)o.q / (unsigned)T;
    o.t = o.q - o.u * T;
    o.b = (unsigned)o.u / (unsigned)S;
    o.s = o.u - o.b * S;
    o.row0 = o.t * p.tile_rows;
    o.rows = min(p.tile_rows, p.L - o.row0);
    return o;
  };

  // The copies of round r's tile into ring slot r % kRing, as one group
  // (empty past the last round, so that the group count stays uniform).
  // Each thread copies the 16 bytes it reduces and normalizes.
  auto issue = [&](int r) {
    if (r < nr) {
      const Slot o = slot(r);
      Tx* dst = ring + (r % kRing) * tile_elems + v * N;
      const Tx* src = x + ((size_t)o.b * p.L + o.row0) * p.C + (size_t)o.s * cs + v * N;
      for (int row = rs; row < o.rows; row += rp)
        cp_async16(dst + row * cs, src + (size_t)row * p.C);
    }
    cp_async_commit();
  };

  // Round r's tile (its copies complete) to per-group (sum, sumsq) in a
  // fixed order: rows in the thread, channels into groups, a butterfly over
  // the warp's lanes that share groups, then the warps in order. Returns
  // them in st[0, 2m) of the slot's ring entry.
  auto reduce = [&](int r) {
    const Slot o = slot(r);
    const Tx* tile = ring + (r % kRing) * tile_elems + v * N;
    float s[N], q[N];
#pragma unroll
    for (int j = 0; j < N; ++j) { s[j] = 0.f; q[j] = 0.f; }
    for (int row = rs; row < o.rows; row += rp) {
      float val[N];
      load_vec(tile + row * cs, val);
#pragma unroll
      for (int j = 0; j < N; ++j) { s[j] += val[j]; q[j] += val[j] * val[j]; }
    }
    // channels into this thread's groups: a pairwise tree, group k at j = k * per
    const int per = N / gt;
#pragma unroll
    for (int w = 1; w < N; w <<= 1) {
      if (w < per) {
#pragma unroll
        for (int j = 0; j + w < N; j += 2 * w) {
          s[j] += s[j + w];
          q[j] += q[j + w];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if ((j & (per - 1)) == 0) {  // uniform over the warp
        float gs = s[j], gq = q[j];
        for (int off = 16; off >= vr; off >>= 1) {
          gs += __shfl_xor_sync(0xffffffffu, gs, off);
          gq += __shfl_xor_sync(0xffffffffu, gq, off);
        }
        for (int off = vpg >> 1; off >= 1; off >>= 1) {
          gs += __shfl_xor_sync(0xffffffffu, gs, off);
          gq += __shfl_xor_sync(0xffffffffu, gq, off);
        }
        if (lane < vr && v % vpg == 0) {
          const int g = (v * N + j) / cg;
          wsum[warp * 2 * m + g] = gs;
          wsum[warp * 2 * m + m + g] = gq;
        }
      }
    }
    __syncthreads();
    float* st = stats + (r % kRing) * 2 * m;
    for (int k = threadIdx.x; k < 2 * m; k += kResThreads) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) acc += wsum[w * 2 * m + k];
      st[k] = acc;
      if (T > 1) st_tagged(p.slot_tags + (size_t)o.q * 2 * m + k, acc, epoch);
    }
    __syncthreads();
  };

  // The unit of round r's slot: its T tiles' tagged sums, folded tile by
  // tile in order into st[0, 2m). gather_start loads a thread's first
  // kGather words early (their latency hides behind the next tile's
  // reduction); gather_end polls the ones not yet tagged with this launch's
  // epoch (their tiles still in flight) and folds.
  const int gcols = 2 * m, gparts = kResThreads / gcols;  // 2m <= 512 (the wrapper's rule)
  const int gchunk = (T + gparts - 1) / gparts;
  const int gcol = threadIdx.x % gcols, gpart = threadIdx.x / gcols;
  const int gt0 = gpart * gchunk, gt1 = gpart < gparts ? min(T, gt0 + gchunk) : gt0;
  unsigned long long gword[kGather];
  auto gather_start = [&](const Slot& o) {
    const unsigned long long* src = p.slot_tags + (size_t)o.u * T * gcols + gcol;
#pragma unroll
    for (int i = 0; i < kGather; ++i) {  // weak loads: the thread runs on until their use
      gword[i] = 0ull;
      if (gt0 + i < gt1) gword[i] = __ldcg(src + (size_t)(gt0 + i) * gcols);
    }
  };
  auto gather_end = [&](const Slot& o, float* st) {
    const unsigned long long* src = p.slot_tags + (size_t)o.u * T * gcols + gcol;
    long long start = 0;
    auto settle = [&](unsigned long long w, int t) {
      while ((unsigned)(w >> 32) != epoch) {
        if (start == 0) start = clock64();
        else if (clock64() - start > (1ll << 34)) __trap();
        w = ld_tagged(src + (size_t)t * gcols);
      }
      return __uint_as_float((unsigned)w);
    };
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kGather; ++i)
      if (gt0 + i < gt1) acc += settle(gword[i], gt0 + i);
    for (int t = gt0 + kGather; t < gt1; ++t) acc += settle(ld_tagged(src + (size_t)t * gcols), t);
    if (gpart < gparts) fold[gpart * gcols + gcol] = acc;
    __syncthreads();
    for (int k = threadIdx.x; k < gcols; k += kResThreads) {
      float sum = 0.f;
      for (int i = 0; i < gparts; ++i) sum += fold[i * gcols + k];
      st[k] = sum;
    }
    __syncthreads();
  };

  // From the unit's sums in st: mean and rstd in st; the block of the unit's
  // tile 0 writes the backward's statistics (sums in tile 0, zeros in the
  // other tiles).
  auto finish = [&](const Slot& o, float* st) {
    for (int j = threadIdx.x; j < m; j += kResThreads) {
      const float sum = st[j], sq = st[m + j];
      if (o.t == 0) {
        const int g = o.s * m + j;
        p.partial[((size_t)o.b * p.tiles_bwd * 2) * p.G + g] = sum;
        p.partial[((size_t)o.b * p.tiles_bwd * 2 + 1) * p.G + g] = sq;
      }
      const float mean = sum / denom;
      const float var = fmaxf(sq / denom - mean * mean, 0.f);
      st[j] = mean;
      st[m + j] = rsqrtf(var + p.eps);
    }
    __syncthreads();
    if (o.t != 0) return;
    for (int i = threadIdx.x; i < (p.tiles_bwd - 1) * 2 * m; i += kResThreads) {
      const int t = 1 + i / (2 * m), k = i % (2 * m);
      p.partial[(((size_t)o.b * p.tiles_bwd + t) * 2 + k / m) * p.G + o.s * m + k % m] = 0.f;
    }
  };

  auto normalize = [&](int r) {
    const Slot o = slot(r);
    const Tx* tile = ring + (r % kRing) * tile_elems + v * N;
    const float* st = stats + (r % kRing) * 2 * m;
    float sc[N], sh[N];  // y = x * sc + sh, sc = rstd * gamma, sh = beta - mean * sc
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = v * N + j, ch = o.s * cs + c;
      sc[j] = st[m + c / cg] * __ldg(p.gamma + ch);
      sh[j] = __ldg(p.beta + ch) - st[c / cg] * sc[j];
    }
    Tx* dst = static_cast<Tx*>(p.y) + ((size_t)o.b * p.L + o.row0) * p.C + (size_t)o.s * cs +
              v * N;
    for (int row = rs; row < o.rows; row += rp) {
      float val[N];
      load_vec(tile + row * cs, val);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float t = fmaf(val[j], sc[j], sh[j]);
        if (SILU) t = silu(t);
        val[j] = t;
      }
      store_vec(dst + (size_t)row * p.C, val);
    }
  };

  // Round r + kLag is reduced and tagged before round r waits on its unit.
  for (int r = 0; r < kRing - 1; ++r) issue(r);
  cp_async_wait<kRing - 2>();
  reduce(0);
  for (int r = 0; r < nr; ++r) {
    issue(r + kRing - 1);  // into the slot that round r - 1 freed
    const Slot o = slot(r);
    if (T > 1) gather_start(o);
    if (r + kLag < nr) {
      cp_async_wait<kRing - kLag - 1>();
      reduce(r + kLag);
    }
    float* st = stats + (r % kRing) * 2 * m;
    if (T > 1) gather_end(o, st);
    finish(o, st);
    normalize(r);
    __syncthreads();
  }
  if (T > 1) {
    // the last block out advances the epoch for the next launch
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(&p.state[1], 1) == (int)gridDim.x - 1) {
      p.state[1] = 0;
      p.state[0] = (int)epoch;
    }
  }
}

template <typename Tx, bool SILU>
int launch_resident(const ResidentParams& p, int grid, cudaStream_t stream) {
  auto kernel = gn_fwd_resident_kernel<Tx, SILU>;
  static unsigned configured = 0;  // one bit per device: the shared-memory limit was raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  const int m = p.cs / (p.C / p.G);
  const size_t smem = resident_smem(p.cs, p.tile_rows, m, (int)sizeof(Tx));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (p.tiles > 1) {
    // blocks wait on each other's tiles: all must be resident (else the launch is refused)
    ResidentParams arg = p;
    void* args[] = {&arg};
    return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kResThreads),
                                            args, smem, stream);
  }
  kernel<<<grid, kResThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename Tx>
int resident(const ResidentParams& p, int grid, int silu, cudaStream_t s) {
  return silu ? launch_resident<Tx, true>(p, grid, s) : launch_resident<Tx, false>(p, grid, s);
}

}  // namespace

extern "C" {

// The two-pass route. x, y: (B, L, C) contiguous, fp32 (dtype 0) or bf16
// (dtype 1); gamma, beta: (C,) fp32; partial: (B, tiles, 2, G) fp32. Shapes
// are checked by the Python wrapper: C % G == 0, C / (16 / sizeof(elem)) <=
// 256, 16-byte aligned pointers, tiles == ceil(L / rows_per_tile). Returns
// cudaGetLastError().
int gdt_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                       void* partial, int B, int L, int C, int G, int rows_per_tile,
                       int tiles, float eps, int silu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_two_pass<float>(x, gamma, beta, y, partial, B, L, C, G, rows_per_tile,
                                  tiles, eps, silu, s);
  if (dtype == 1)
    return launch_two_pass<__nv_bfloat16>(x, gamma, beta, y, partial, B, L, C, G,
                                          rows_per_tile, tiles, eps, silu, s);
  return (int)cudaErrorInvalidValue;
}

// The two-pass route's stats pass alone plus the affine fold: partial as
// above, a and b (B, C) fp32. Same checks and tiling as gdt_group_norm_fwd.
int gdt_group_norm_affine(const void* x, const void* gamma, const void* beta, void* partial,
                          void* a, void* b, int B, int L, int C, int G, int rows_per_tile,
                          int tiles, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_stats<float>(x, partial, B, L, C, G, rows_per_tile, tiles, s);
  else if (dtype == 1)
    err = launch_stats<__nv_bfloat16>(x, partial, B, L, C, G, rows_per_tile, tiles, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  gn_affine_kernel<<<B, kThreads, 2 * G * sizeof(float), s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(a), static_cast<float*>(b), L, C,
      G, tiles, eps);
  return (int)cudaGetLastError();
}

// The resident kernel: y = GroupNorm(+SiLU) of x. partial: the backward's
// (B, tiles_bwd, 2, G); slot_tags: uint64 scratch of the wrapper's rule's
// size, zero when made; state: [epoch, exits] int32, zero when made (both
// kept between launches by the wrapper). The rule gives cs, tiles, tile_rows
// and grid (tiles <= grid). Returns the launch's error code.
int gdt_group_norm_resident(const void* x, const void* gamma, const void* beta, void* y,
                            void* partial, void* slot_tags, void* state, int B, int L, int C,
                            int G, int cs, int tiles, int tile_rows, int tiles_bwd, int grid,
                            float eps, int silu, int dtype, void* stream) {
  ResidentParams p;
  p.x = x;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.y = y;
  p.partial = static_cast<float*>(partial);
  p.slot_tags = static_cast<unsigned long long*>(slot_tags);
  p.state = static_cast<int*>(state);
  p.B = B; p.L = L; p.C = C; p.G = G; p.cs = cs; p.tiles = tiles; p.tile_rows = tile_rows;
  p.tiles_bwd = tiles_bwd; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return resident<float>(p, grid, silu, s);
  if (dtype == 1) return resident<__nv_bfloat16>(p, grid, silu, s);
  return (int)cudaErrorInvalidValue;
}

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
