// Flash attention for head dims above 128, forward and backward, for
// Hopper (sm_90a), hand-written CUDA C++: the rows route.
//
// The route of `_flash_kernel` (fedml_tpu/ops/flash_attention.py:32,
// pl.pallas_call at :83) and of its backward `_bwd` (:140-175) for the
// head dims the D <= 128 kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) do not take: 129 to 512, run at a padded Dp (a
// multiple of 64; the bf16 forward 192, 256, 384 or 512) that the wrapper
// zero-pads, which leaves every score and every real output column as it
// was. Same function and outputs: O [B, T, H, Dp] in the input dtype and
// lse = m + log(max(l, 1e-30)) as f32 [B, H, T]; dQ, dK, dV from the
// saved lse by the FlashAttention-2 recompute. f32 or bf16 inputs, causal
// masking with -1e30, any T (tiles past grid y's 65,535 fold into grid x:
// `work_grid`, `block_work`). No atomics on any output: every element is
// summed in one fixed order, so two runs agree bitwise.
//
// Bound on an H100: attention at these shapes does ~T/2 operations per
// byte it must move (causal), far above the card's balance point, so
// operations bound it: 2 products of 2 x D flops per (query, key) pair
// forward, 5 backward, on the tensor cores. What the design meets first
// is the L2 -> shared memory stream, a tile pair's bytes read from L2
// against its products: a first forward of 64-query tiles that streamed
// Q, K and V kept most of its time with its products taken out, so the
// choices below are about bytes per product.
//
// What held the earlier design back: one warp owned one row and walked
// the keys one at a time, each a dot product finished by a shuffle
// butterfly and a serial online-softmax step, with no tile staged in
// shared memory and no tensor core running (0.4-1.6% of the bound,
// 13-192x slower than SDPA). Every kernel here is the D <= 128 kernels'
// design (tiles by TMA through mbarrier rings, every product on `wgmma`)
// widened past what one warpgroup's registers and one block's shared
// memory hold, with 256-thread blocks of two consumer warpgroups:
// - bf16 forward (`rows_fwd_bf16_kernel<Dp>`): a block owns 128 queries,
//   64 a warpgroup, each with its rows' whole S; Q stays resident and
//   both warpgroups read every K and V tile of one shared ring (the second
//   to release a stage refills it), so each K/V byte serves 128 queries.
//   O is held in 64-column units (4 at Dp 256, 128 registers); above Dp
//   256 a block owns half of O's columns (grid z 2) and recomputes S, and
//   key tiles are 32. The products and the softmax overlap as in the D <=
//   128 kernel (S of tile i + 1 and P V of tile i issued together), which
//   the compile-time counts of the template let the compiler schedule.
// - bf16 backward at Dp 256 (`rows_dkdv128_kernel`, `rows_dq128_kernel`):
//   the same pattern, 128 keys (queries) a block with K and V (Q and dO)
//   resident and one shared ring of Q and dO (K and V) tiles of 32 rows;
//   dQ holds all 256 columns, dK and dV half of them (grid z 2, S^T and
//   dP^T recomputed). A step's products land before the next step's.
// - Everything else (f32 forward, the other backward launches): each warpgroup
//   streams half of the head dim's chunks (64 columns in bf16, 32 in f32:
//   one 128-byte TMA box) through its own ring and forms a partial S (and
//   dP); the halves meet in shared memory (`exchange`, two named
//   barriers) and both warpgroups add them, own + other, the same sum in
//   both (f32 addition commutes), so the softmax is identical in both.
//   Each warpgroup owns up to two 64-column output units (dK and dV: 128
//   registers); a block holds four, so above Dp 256 two blocks share a
//   tile (grid z), each recomputing S. The bf16 backward keeps the
//   warpgroup's chunks of K and V (dK/dV) or Q and dO (dQ) resident and
//   streams the other pair, and up to Dp 256 reads its units from the S
//   items; f32 streams every operand (a [64, 512] tile as TF32 hi/lo is
//   256 KB). The rings' counts are runtime values, so
//   each phase's products land before any register they own is touched:
//   overlapping them, as the forward does, made ptxas serialize every
//   wgmma (its C7514/C7515/C7520 notes), several times slower.
// Accuracy, as each route's D <= 128 sibling: bf16 S and dP are one bf16
// pass (bf16 products are exact, f32 sums); P and dS are split into bf16
// hi + lo, two passes into one f32 accumulator. f32 runs 3xTF32 (lo*hi +
// hi*lo + hi*hi) on TF32 `wgmma`: a pre-pass (`rows_*_split_kernel`)
// writes each f32 operand as TF32 hi and lo planes, and those that a
// product contracts over rows (V in P V; Q and dO in dK and dV; K in dQ)
// also transposed, [B, H, Dp, Tp] with keys (queries) in the k order in
// which `wgmma` reads an accumulator fed back as A (`kpos`), since TF32
// `wgmma` has no transpose bit. P and dS are split in registers.
// Passes per tile pair, in units of a 64 x 64 x Dp product, against the
// bound's 2 (forward) and 5 (backward): bf16 forward 1 + 2 (S twice above
// Dp 256), backward dK/dV 2 + 4 and dQ 2 + 2 (S and dP twice above Dp
// 256); f32 three times each.

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kWg = 128;           // threads a warpgroup
constexpr int kThreads = 2 * kWg;  // two consumer warpgroups a block
constexpr int kUnit = 64;          // output columns a unit
constexpr int kWgUnits = 2;        // units a warpgroup
constexpr int kBlockUnits = 2 * kWgUnits;
constexpr int kBox = 64 * 128;     // one 128-byte-wide TMA box of 64 rows
constexpr int kSmem = 232448;      // a block's shared memory (227 KB)
constexpr int kBarBytes = 1024;    // the barriers, after the rings and the exchange
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kLog2e = 1.44269504088896340736f;

// Per input dtype: planes per operand (bf16 is exact in one; f32 is TF32
// hi and lo), the columns of one S chunk (one 128-byte box), the query
// step of the dK/dV kernel and the key step of the dQ kernel.
template <typename T>
struct Route;
template <>
struct Route<bf16> {
  static constexpr int kPlanes = 1, kChunk = 64, kDkdvBQ = 32, kDqBK = 32;
};
template <>
struct Route<float> {
  static constexpr int kPlanes = 2, kChunk = 32, kDkdvBQ = 32, kDqBK = 32;
};

// Per warpgroup: kRes bytes of resident tiles, a ring of kStages stages
// of kStage bytes, and an exchange buffer of kX bytes, in 227 KB. The
// block's layout: both resident regions, both rings, both exchange
// buffers, the barriers.
template <int kStage, int kX, int kRes = 0>
struct Budget {
  static constexpr int kStages = (kSmem - kBarBytes - 2 * kX - 2 * kRes) / 2 / kStage;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kRings = 2 * kRes;                 // the rings' offset
  static constexpr int kXOff = kRings + 2 * kRing;        // the exchange buffers'
  static constexpr int kBars = kXOff + 2 * kX;            // the barriers'
  static constexpr int kSmemBytes = kBars + kBarBytes;
  static_assert(kStages >= 3, "a ring of at least three stages");
  static_assert(kStage % 1024 == 0 && kX % 1024 == 0, "boxes start on 1024-byte boundaries");
};

// The f32 forward: 64 queries a block, key tiles of 64. An S stage holds
// Q's and K's chunk (hi and lo, a box each); a unit stage V^T's unit (hi
// and lo [64 columns, 64 keys]).
struct FwdCfg {
  static constexpr int kBQ = 64, kBK = 64;
  static constexpr int kChunkTile = 2 * kBox;
  static constexpr int kSItem = 2 * kChunkTile;
  static constexpr int kUItem = 2 * (kBK / 32) * kBox;
  static constexpr int kStage = kSItem > kUItem ? kSItem : kUItem;
  using B = Budget<kStage, kBQ * kBK * 4>;
};

// dK/dV: 64 keys a block, query steps of kBQ. bf16 keeps the warpgroup's
// chunks of K and V resident (up to 4 each) and streams (Q, dO) chunks;
// f32 streams (K, Q) chunks and (V, dO) chunks. Unit stages: dO's unit
// (for dV), then Q's (for dK), natural [kBQ, 64] in bf16, transposed hi
// and lo [64, kBQ] in f32.
template <typename T>
struct DkdvCfg {
  using R = Route<T>;
  static constexpr bool kResident = R::kPlanes == 1;
  static constexpr int kBK = 64, kBQ = R::kDkdvBQ;
  static constexpr int kKTile = kBox * R::kPlanes;                  // [64, chunk]
  static constexpr int kQTile = kBQ * 128 * R::kPlanes;             // [kBQ, chunk]
  static constexpr int kRes = kResident ? 8 * kBox : 0;             // K, then V
  static constexpr int kSItem = kResident ? 2 * kQTile : kKTile + kQTile;
  static constexpr int kUItem = R::kPlanes == 1 ? kBQ * 128 : 2 * (kBQ / 32) * kBox;
  static constexpr int kStage = kSItem > kUItem ? kSItem : kUItem;
  using B = Budget<kStage, 2 * kBK * kBQ * 4, kRes>;
};

// dQ: 64 queries a block, key steps of kBK. bf16 keeps the warpgroup's
// chunks of Q and dO resident and streams (K, V) chunks; f32 streams
// (Q, K) chunks and (dO, V) chunks. Unit stages: K's unit, natural [kBK,
// 64] in bf16, transposed hi and lo [64, kBK] in f32.
template <typename T>
struct DqCfg {
  using R = Route<T>;
  static constexpr bool kResident = R::kPlanes == 1;
  static constexpr int kBQ = 64, kBK = R::kDqBK;
  static constexpr int kQTile = kBox * R::kPlanes;
  static constexpr int kKTile = kBK * 128 * R::kPlanes;
  static constexpr int kRes = kResident ? 8 * kBox : 0;             // Q, then dO
  static constexpr int kSItem = kResident ? 2 * kKTile : kQTile + kKTile;
  static constexpr int kUItem = R::kPlanes == 1 ? kBK * 128 : 2 * (kBK / 32) * kBox;
  static constexpr int kStage = kSItem > kUItem ? kSItem : kUItem;
  using B = Budget<kStage, 2 * kBQ * kBK * 4, kRes>;
};

// ---- shared pieces ----------------------------------------------------------------

// The column of a transposed plane that row r goes to: within each 8,
// rows 2t and 2t + 1 go to columns t and t + 4, the k order in which
// wgmma reads an accumulator fed back as its A operand (columns 2t, 2t + 1
// as k t, t + 4)
__device__ __forceinline__ int kpos(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// Descriptor of k-step ks (32 bytes: 16 bf16 or 8 f32 columns) of a
// [rows, 128-byte] box read K-major
__device__ __forceinline__ uint64_t kdesc(const unsigned char* box, int ks) {
  return smem_desc(box + 32 * ks, 128, 16, 8 * 128);
}
// Descriptor of k-step kk (16 rows) of a bf16 [kRows, 64] box read
// MN-major (the reduction runs along the rows)
template <int kRows>
__device__ __forceinline__ uint64_t mndesc(const unsigned char* box, int kk) {
  return smem_desc(box + kk * 16 * 128, 128, kRows * 128, 8 * 128);
}
// Descriptor of k-step kk (8 columns) of an f32 [64, n] tile stored as
// n / 32 boxes of 64 rows, read K-major
__device__ __forceinline__ uint64_t tdesc(const unsigned char* tile, int kk) {
  return smem_desc(tile + (kk >> 2) * kBox + (kk & 3) * 32, 128, 16, 8 * 128);
}

// This thread's warpgroup, read from lane 0 so that the compiler knows it
// is the same in every lane of a warp: branches on it around wgmma are
// then not divergent (which would serialize every wgmma)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / kWg, 0);
}

// Named barriers: the warpgroup alone (ids 1, 2), the block's pair (3)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kWg) : "memory");
}
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 3, %0;" ::"n"(kThreads) : "memory");
}

// The two warpgroups' partial sums (each N floats a thread over the
// warpgroup's half of the head dim), made whole in both: each stores its
// own, then adds the other's to its own (f32 addition commutes, so both
// hold the same sum). `xbuf` holds 2 x N x 128 floats.
template <int N>
__device__ __forceinline__ void put(const float (&a)[N], float* dst, int tid) {
#pragma unroll
  for (int e = 0; e < N; ++e) dst[e * kWg + tid] = a[e];
}
template <int N>
__device__ __forceinline__ void add(float (&a)[N], const float* src, int tid) {
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] += src[e * kWg + tid];
}
template <int N>
__device__ __forceinline__ void exchange(float (&a)[N], float* xbuf, int wg, int tid) {
  put(a, xbuf + wg * N * kWg, tid);
  pair_sync();
  add(a, xbuf + (1 - wg) * N * kWg, tid);
  pair_sync();  // both have read before either writes again
}
template <int N, int M>
__device__ __forceinline__ void exchange(float (&a)[N], float (&b)[M], float* xbuf, int wg,
                                         int tid) {
  float* mine = xbuf + wg * (N + M) * kWg;
  const float* other = xbuf + (1 - wg) * (N + M) * kWg;
  put(a, mine, tid);
  put(b, mine + N * kWg, tid);
  pair_sync();
  add(a, other, tid);
  add(b, other + N * kWg, tid);
  pair_sync();
}

// Thread 0: rows `row` ..  of (b, h), columns `col` .. + chunk, of every
// plane of an operand, one box each, one after the other from `dst`
template <int kPlanes, int kRows>
__device__ __forceinline__ void load_rows(const CUtensorMap* maps, unsigned char* dst,
                                          uint64_t* bar, int col, int h, int row, int b) {
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) tma_load(dst + p * kRows * 128, &maps[p], bar, col, h, row, b);
}

// Thread 0: the transposed planes' [64 columns, n] tile at column unit u
// and rows (keys or queries) r0 .. r0 + n, hi then lo, n / 32 boxes each
template <int kN>
__device__ __forceinline__ void load_t(const CUtensorMap* maps, unsigned char* dst, uint64_t* bar,
                                       int u, int h, int r0, int b) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int x = 0; x < kN / 32; ++x)
      tma_load(dst + (p * (kN / 32) + x) * kBox, &maps[p], bar, r0 + 32 * x, h, kUnit * u, b);
}

// d (+)= A B^T over one chunk: A a [64, chunk] tile, B a [n, chunk] tile
// (both K-major, each plane one box, `b_plane` bytes apart); bf16 one
// pass, f32 three (lo hi, hi lo, hi hi). `first` overwrites d.
template <typename T, int N>
__device__ __forceinline__ void chunk_product(float (&d)[N], const unsigned char* a,
                                              const unsigned char* b, int b_plane, bool first) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int acc = !(first && ks == 0);
    if constexpr (Route<T>::kPlanes == 1) {
      wgmma_ss<0>(d, kdesc(a, ks), kdesc(b, ks), acc);
    } else {
      const uint64_t a_hi = kdesc(a, ks), a_lo = kdesc(a + kBox, ks);
      const uint64_t b_hi = kdesc(b, ks), b_lo = kdesc(b + b_plane, ks);
      wgmma_tf32_ss(d, a_lo, b_hi, acc);
      wgmma_tf32_ss(d, a_hi, b_lo, 1);
      wgmma_tf32_ss(d, a_hi, b_hi, 1);
    }
  }
}

// The A operands of an accumulator of n columns (the reduction's k),
// for the product with a unit: bf16 hi/lo pairs per k-step of 16, f32
// TF32 hi/lo per k-step of 8 (elements 0, 2, 1, 3: kpos's order)
template <typename T, int N>
struct AOps {
  static constexpr int kSteps = Route<T>::kPlanes == 1 ? N / 8 : N / 4;
  uint32_t hi[kSteps][4], lo[kSteps][4];
  __device__ __forceinline__ void make(const float (&d)[N]) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if constexpr (Route<T>::kPlanes == 1) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
      } else {
        split(d[4 * kk], hi[kk][0], lo[kk][0]);
        split(d[4 * kk + 2], hi[kk][1], lo[kk][1]);
        split(d[4 * kk + 1], hi[kk][2], lo[kk][2]);
        split(d[4 * kk + 3], hi[kk][3], lo[kk][3]);
      }
    }
  }
  __device__ __forceinline__ void fence() {
    fence_regs(hi);
    fence_regs(lo);
  }
};

// acc (64 columns) += A U over the operands' k: U a bf16 [k, 64] box read
// MN-major, or an f32 transposed [64, k] tile, hi then lo (`u_plane`
// bytes apart); two passes (lo, hi) in bf16, three in f32
template <typename T, int kK, int N>
__device__ __forceinline__ void unit_product(float (&acc)[32], const AOps<T, N>& a,
                                             const unsigned char* u, int u_plane) {
#pragma unroll
  for (int kk = 0; kk < AOps<T, N>::kSteps; ++kk) {
    if constexpr (Route<T>::kPlanes == 1) {
      const uint64_t d = mndesc<kK>(u, kk);
      wgmma_rs<1>(acc, a.lo[kk], d);
      wgmma_rs<1>(acc, a.hi[kk], d);
    } else {
      const uint64_t hi = tdesc(u, kk), lo = tdesc(u + u_plane, kk);
      wgmma_tf32_rs(acc, a.lo[kk], hi);
      wgmma_tf32_rs(acc, a.hi[kk], lo);
      wgmma_tf32_rs(acc, a.hi[kk], hi);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) { return __bfloat162float(*p); }

// The ring of one warpgroup: `total` items, each in stage i % kStages,
// loaded by `issue(i)` (thread 0); an item's stage is refilled with item
// i + kStages once the products that read it have completed in every
// warp (`release`). Products are not waited for item by item: a wait
// comes where registers are needed (the exchange, the softmax) or where
// the ring is full (`room`).
template <int kStages, int kStage>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  int total, freed;
  __device__ __forceinline__ unsigned char* stage(int i) const {
    return base + (i % kStages) * kStage;
  }
  __device__ __forceinline__ uint64_t* bar(int i) const { return full + i % kStages; }
  __device__ __forceinline__ void wait(int i) const { mbar_wait(bar(i), (i / kStages) & 1); }
  // items below `upto` are done: free their stages for the items kStages on
  template <typename Issue>
  __device__ __forceinline__ void release(int upto, int wg, int tid, Issue& issue) {
    if (upto <= freed) return;
    wg_sync(wg);
    if (tid == 0)
      for (int k = freed; k < upto; ++k)
        if (k + kStages < total) issue(k + kStages);
    freed = upto;
  }
  // Before item i is waited for: if the ring has not issued it yet (every
  // stage holds an item whose products may be in flight), wait for all
  // but the latest product group and free the stages of the items before
  // it. Each item's products are one commit group, committed in order.
  // (No register is read or written here: touching the accumulators or
  // operands of the group still in flight would serialize every wgmma.)
  template <typename Issue>
  __device__ __forceinline__ void room(int i, int wg, int tid, Issue& issue) {
    if (i < freed + kStages) return;
    wgmma_wait<1>();
    release(i - 1, wg, tid, issue);
  }
};

// This warpgroup's share of a head dim of `dp` columns in block z: S
// chunks [c0, c0 + nc) and output units [u0, u0 + nu)
template <typename T>
struct Share {
  int c0, nc, u0, nu;
  __device__ __forceinline__ Share(int dp, int wg) {
    const int chunks = dp / Route<T>::kChunk, half = (chunks + 1) / 2;
    c0 = wg * half;
    nc = min(chunks, c0 + half) - c0;
    u0 = blockIdx.z * kBlockUnits + wg * kWgUnits;
    nu = max(0, min(kWgUnits, dp / kUnit - u0));
  }
};

__device__ __forceinline__ void init_ring(uint64_t* full, int stages, int tid) {
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// ---- forward ------------------------------------------------------------------

struct FwdMaps {
  CUtensorMap q[2], k[2], v[2];  // hi, lo (v: V^T)
};

// The f32 forward (the bf16 one is rows_fwd_bf16_kernel below): O and lse
// of one 64-query tile of one (b, h), units [4z, 4z + 4) of O.
// Thread (warp w, lane 4g + t) of a warpgroup owns queries 16w + g and
// 16w + g + 8; its S accumulators hold keys 8j + 2t and 8j + 2t + 1, its
// O accumulators columns 8j + 2t and 8j + 2t + 1 of each unit.
__global__ void __launch_bounds__(kThreads, 1)
rows_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, float* __restrict__ o,
                      float* __restrict__ lse, int n_bh, int seq_len, int heads, int dp,
                      float scale_log2, int causal) {
  using T = float;
  using C = FwdCfg;
  constexpr int BQ = C::kBQ, BK = C::kBK, NS = C::B::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = warpgroup(), tid = threadIdx.x % kWg, warp = tid >> 5, lane = tid & 31;
  int bh, rank;  // high query tiles walk the most key tiles
  const int n_qt = (seq_len + BQ - 1) / BQ;
  if (!block_work(n_bh, n_qt, bh, rank)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (n_qt - 1 - rank) * BQ;
  int n_kt = (seq_len + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);  // later tiles fully masked
  const Share<T> sh(dp, wg);
  const int per_tile = sh.nc + sh.nu;
  float* xbuf = reinterpret_cast<float*>(smem + C::B::kXOff);
  Ring<NS, C::kStage> ring{smem + C::B::kRings + wg * C::B::kRing,
                           reinterpret_cast<uint64_t*>(smem + C::B::kBars) + wg * NS,
                           n_kt * per_tile, 0};
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();  // the swizzle's 1024-byte boxes
  init_ring(ring.full, NS, tid);
  __syncthreads();
  // per key tile: this warpgroup's chunks of Q and K, then its units of V
  auto issue = [&](int i) {
    const int kt = i / per_tile, j = i % per_tile;
    unsigned char* st = ring.stage(i);
    uint64_t* bar = ring.bar(i);
    if (j < sh.nc) {
      const int col = (sh.c0 + j) * Route<T>::kChunk;
      mbar_expect_tx(bar, C::kSItem);
      load_rows<Route<T>::kPlanes, BQ>(maps.q, st, bar, col, h, q0, b);
      load_rows<Route<T>::kPlanes, BK>(maps.k, st + C::kChunkTile, bar, col, h, kt * BK, b);
    } else {
      mbar_expect_tx(bar, C::kUItem);
      load_t<BK>(maps.v, st, bar, sh.u0 + j - sh.nc, h, kt * BK, b);
    }
  };
  if (tid == 0)
    for (int i = 0; i < NS && i < ring.total; ++i) issue(i);

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's queries: row0, row0 + 8
  float acc[kWgUnits][32], sc[BK / 2];
  AOps<T, BK / 2> p{};
#pragma unroll
  for (int j = 0; j < kWgUnits; ++j) zero(acc[j]);
  zero(sc);
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // running sum, this thread's columns only
  auto settle = [&]() {  // after a wait: the registers in-flight products own
#pragma unroll
    for (int j = 0; j < kWgUnits; ++j) fence_regs(acc[j]);
    fence_regs(sc);
    p.fence();
  };

  int i = 0;
  // this warpgroup's half of S = Q K^T of the key tile, chunk by chunk
  auto scores = [&]() {
    for (int j = 0; j < sh.nc; ++j, ++i) {
      ring.room(i, wg, tid, issue);
      ring.wait(i);
      const unsigned char* st = ring.stage(i);
      wgmma_fence();
      chunk_product<T>(sc, st, st + C::kChunkTile, BK * 128, j == 0);
      wgmma_commit();
    }
  };
  // the whole S of key tile kt (exchanged), masked, then the online
  // softmax: the new row max, P in place of S, l and O rescaled, P's A
  // operands; element 4j + e is query row0 + 8(e >> 1), key k0 + 8j + 2t
  // + (e & 1)
  auto softmax = [&](int kt) {
    exchange(sc, xbuf, wg, tid);
    const int k0 = kt * BK;
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > seq_len) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), q = row0 + 8 * (e >> 1);
          if (key >= seq_len || (causal && key > q)) sc[4 * j + e] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]}, ms[2], corr[2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_ftz((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const float pe = exp2_ftz(fmaf(sc[e], scale_log2, -ms[(e >> 1) & 1]));
      sc[e] = pe;
      l[(e >> 1) & 1] += pe;
    }
#pragma unroll
    for (int j = 0; j < kWgUnits; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[j][e] *= corr[(e >> 1) & 1];
    p.make(sc);
  };
  // O += P V of the key tile, unit by unit
  auto values = [&]() {
#pragma unroll
    for (int j = 0; j < kWgUnits; ++j) {
      if (j < sh.nu) {
        ring.room(i, wg, tid, issue);
        ring.wait(i);
        const unsigned char* st = ring.stage(i);
        wgmma_fence();
        unit_product<T, BK>(acc[j], p, st, (BK / 32) * kBox);
        wgmma_commit();
        ++i;
      }
    }
  };
  // Each phase's products land before registers they own are touched:
  // overlapping the softmax with P V (which the D <= 128 kernels do)
  // makes the compiler serialize every wgmma here, whose chunk and unit
  // counts are runtime values; the other warpgroup's products and the
  // ring's loads run meanwhile.
  for (int kt = 0; kt < n_kt; ++kt) {
    scores();
    wgmma_wait<0>();
    settle();
    ring.release(i, wg, tid, issue);
    softmax(kt);
    values();
    wgmma_wait<0>();
    settle();
    ring.release(i, wg, tid, issue);
  }

  // epilogue: each row's sum across its quad, then O and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int q = row0 + 8 * r;
    if (q >= seq_len) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    if (t == 0 && wg == 0 && blockIdx.z == 0)
      lse[(long long)bh * seq_len + q] = m[r] * scale_log2 * kLn2 + logf(lr);
    T* out = o + (((long long)b * seq_len + q) * heads + h) * dp;
#pragma unroll
    for (int j = 0; j < kWgUnits; ++j) {
      if (j >= sh.nu) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        store2(out + kUnit * (sh.u0 + j) + 8 * c + 2 * t, acc[j][4 * c + 2 * r] / lr,
               acc[j][4 * c + 2 * r + 1] / lr);
    }
  }
}

// ---- bf16 forward: 128 queries a block, K and V shared -----------------------

// The bf16 forward at a padded head dim DP of 192, 256, 384 or 512: two
// warpgroups own 64 query rows each of a 128-row tile, and each computes
// its rows' whole S, so no partial scores are exchanged; they share every
// K and V tile, which halves the bytes read from L2 for each product
// against a tile of 64 queries (the streamed design above is bound by
// those reads). Q stays resident. Above DP 256 a block owns one half of
// O's columns (grid z = 2; S is computed by both) and key tiles are 32.
template <int DP>
struct Bf16FwdCfg {
  static constexpr int kZ = DP <= 256 ? 1 : 2;
  static constexpr int kDB = DP / kZ;                // output columns a block
  static constexpr int kUnits = kDB / kUnit;         // 3 or 4
  static constexpr int kBQ = 128, kBK = DP <= 256 ? 64 : 32;
  static constexpr int kRes = kBQ * DP * 2;          // Q: DP / 64 boxes of 128 rows
  static constexpr int kKItem = kBK * DP * 2;        // DP / 64 boxes of kBK rows
  static constexpr int kVItem = kBK * kDB * 2;       // kUnits boxes of kBK rows
  static constexpr int kStage = kKItem;
  static constexpr int kStages = (kSmem - kBarBytes - kRes) / kStage;
  static constexpr int kBars = kRes + kStages * kStage;
  static constexpr int kSmemBytes = kBars + kBarBytes;
  static_assert(DP == 192 || DP == 256 || DP == 384 || DP == 512, "a bf16 forward head dim");
  static_assert(kStages >= 3 && kStage % 1024 == 0, "a ring of 1024-byte-aligned stages");
};

struct Bf16FwdMaps {
  CUtensorMap q, k, v;  // boxes of 64 columns: 128 query rows, kBK key rows
};

// O and lse of one 128-query tile of one (b, h), columns [z kDB, (z + 1)
// kDB). Thread (warp w, lane 4g + t) of warpgroup wg owns queries 64 wg +
// 16w + g and + 8 of the tile; its S accumulators hold keys 8j + 2t and
// 8j + 2t + 1, its O accumulators columns 8j + 2t and 8j + 2t + 1 of
// each unit. The items of the ring, in the order the products use them:
// K(0), K(1), V(0), K(2), V(1), ..., K(n - 1), V(n - 2), V(n - 1). A
// stage is refilled by whichever warpgroup releases it second (a count
// a stage in shared memory), so neither waits on the other.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
rows_fwd_bf16_kernel(const __grid_constant__ Bf16FwdMaps maps, bf16* __restrict__ o,
                     float* __restrict__ lse, int n_bh, int seq_len, int heads,
                     float scale_log2, int causal) {
  using C = Bf16FwdCfg<DP>;
  constexpr int BQ = C::kBQ, BK = C::kBK, NS = C::kStages, U = C::kUnits;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* ring = smem + C::kRes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* q_bar = full + NS;
  unsigned* released = reinterpret_cast<unsigned*>(q_bar + 1);  // a count a stage
  const int wg = warpgroup(), tid = threadIdx.x % kWg, warp = tid >> 5, lane = tid & 31;
  int bh, rank;  // high query tiles walk the most key tiles
  const int n_qt = (seq_len + BQ - 1) / BQ;
  if (!block_work(n_bh, n_qt, bh, rank)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (n_qt - 1 - rank) * BQ;
  int n_kt = (seq_len + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);  // later tiles fully masked
  const int total = 2 * n_kt;
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzle's 1024-byte boxes
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {
    bool is_k = true;
    int kt = 0;
    if (i > 0) {
      const int j = i - 1, pr = j >> 1;
      is_k = !(j & 1) && pr + 1 < n_kt;
      kt = is_k ? pr + 1 : pr;
    }
    unsigned char* st = ring + (i % NS) * C::kStage;
    uint64_t* bar = &full[i % NS];
    if (is_k) {
      mbar_expect_tx(bar, C::kKItem);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        tma_load(st + c * BK * 128, &maps.k, bar, 64 * c, h, kt * BK, b);
    } else {
      mbar_expect_tx(bar, C::kVItem);
#pragma unroll
      for (int u = 0; u < U; ++u)
        tma_load(st + u * BK * 128, &maps.v, bar, 64 * (blockIdx.z * U + u), h, kt * BK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, C::kRes);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      tma_load(q_s + c * BQ * 128, &maps.q, q_bar, 64 * c, h, q0, b);
    for (int i = 0; i < NS && i < total; ++i) issue(i);
  }
  auto k_item = [&](int kt) { return kt == 0 ? 0 : 2 * kt - 1; };
  auto v_item = [&](int kt) { return kt == n_kt - 1 ? 2 * kt + 1 : 2 * kt + 2; };
  auto wait_item = [&](int i) { mbar_wait(&full[i % NS], (i / NS) & 1); };
  auto stage_of = [&](int i) { return ring + (i % NS) * C::kStage; };
  // this warpgroup is done with item i; the second to say so refills its
  // stage with item i + NS
  auto release = [&](int i) {
    wg_sync(wg);
    if (tid == 0 && (atomicAdd(&released[i % NS], 1u) & 1u) && i + NS < total) issue(i + NS);
  };

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * wg + warp * 16 + g;  // this thread's queries: row0, row0 + 8
  float acc[U][32], sc[BK / 2];
  uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
  for (int u = 0; u < U; ++u) zero(acc[u]);
  zero(sc);
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // running sum, this thread's columns only
  float corr[2];                    // O's rescale for the max's last step
  const unsigned char* q_wg = q_s + 64 * wg * 128;  // this warpgroup's rows of each box
  // S = Q K^T of the tile in `st` into sc (issued, not waited for)
  auto issue_scores = [&](const unsigned char* st) {
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<0>(sc, kdesc(q_wg + c * BQ * 128, ks), kdesc(st + c * BK * 128, ks),
                    c > 0 || ks > 0);
  };
  // O += P V of the tile in `st`, lo then hi, V MN-major, unit by unit
  auto issue_pv = [&](const unsigned char* st) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t d = mndesc<BK>(st + u * BK * 128, kk);
        wgmma_rs<1>(acc[u], p_lo[kk], d);
        wgmma_rs<1>(acc[u], p_hi[kk], d);
      }
  };
  // mask, the new row max, corr, P = exp2(s scale_log2 - m scale_log2) in
  // place of S, l rescaled and summed; element 4j + e is query row0 + 8(e
  // >> 1), key k0 + 8j + 2t + (e & 1)
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    if ((causal && k0 + BK - 1 > q0 + 64 * wg) || k0 + BK > seq_len) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), q = row0 + 8 * (e >> 1);
          if (key >= seq_len || (causal && key > q)) sc[4 * j + e] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_ftz((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const float pe = exp2_ftz(fmaf(sc[e], scale_log2, -ms[(e >> 1) & 1]));
      sc[e] = pe;
      l[(e >> 1) & 1] += pe;
    }
  };

  mbar_wait(q_bar, 0);
  wait_item(0);
  wgmma_fence();
  issue_scores(stage_of(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  release(0);
  softmax(0);
  // Iteration kt: O to tile kt's max and P's operands once P V of tile
  // kt - 1 has landed, then S of tile kt + 1 and P V of tile kt issued,
  // and the softmax of tile kt + 1 while P V runs (the D <= 128 kernels'
  // order); every count here is a compile-time constant, so the compiler
  // can tell which products are in flight where.
  for (int kt = 0; kt < n_kt; ++kt) {
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < U; ++u) fence_regs(acc[u]);
    fence_regs(p_hi);
    fence_regs(p_lo);
    if (kt > 0) release(v_item(kt - 1));
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[u][e] *= corr[(e >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], p_hi[kk][r], p_lo[kk][r]);
    if (kt + 1 < n_kt) {
      const int ki = k_item(kt + 1), vi = v_item(kt);
      wait_item(ki);
      wait_item(vi);
      wgmma_fence();
      issue_scores(stage_of(ki));
      wgmma_commit();
      issue_pv(stage_of(vi));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      release(ki);
      softmax(kt + 1);  // while P V of tile kt is in the tensor cores
    } else {
      const int vi = v_item(kt);
      wait_item(vi);
      wgmma_fence();
      issue_pv(stage_of(vi));
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < U; ++u) fence_regs(acc[u]);

  // epilogue: each row's sum across its quad, then O and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int q = row0 + 8 * r;
    if (q >= seq_len) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    if (t == 0 && blockIdx.z == 0)
      lse[(long long)bh * seq_len + q] = m[r] * scale_log2 * kLn2 + logf(lr);
    bf16* out = o + (((long long)b * seq_len + q) * heads + h) * DP + blockIdx.z * C::kDB;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        store2(out + kUnit * u + 8 * c + 2 * t, acc[u][4 * c + 2 * r] / lr,
               acc[u][4 * c + 2 * r + 1] / lr);
  }
}

// ---- backward -----------------------------------------------------------------

struct DkdvMaps {
  // natural: K and V of 64 rows, Q and dO of kBQ rows; f32 also Q^T and
  // dO^T (transposed planes, boxes of 32 queries); bf16 reads its units
  // from q and dout
  CUtensorMap k[2], q[2], v[2], dout[2], qt[2], dot[2];
};

// dK and dV of one 64-key tile of one (b, h), units [4z, 4z + 4). Thread
// (warp w, lane 4g + t) of a warpgroup owns keys 16w + g and 16w + g + 8;
// its S^T and dP^T accumulators hold queries 8j + 2t and 8j + 2t + 1, its
// dK and dV accumulators columns 8j + 2t and 8j + 2t + 1 of each unit.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rows_dkdv_wgmma_kernel(const __grid_constant__ DkdvMaps maps, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                       int n_bh, int seq_len, int heads, int dp, float scale, int causal) {
  using C = DkdvCfg<T>;
  using R = Route<T>;
  constexpr int BK = C::kBK, BQ = C::kBQ, NS = C::B::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = warpgroup(), tid = threadIdx.x % kWg, warp = tid >> 5, lane = tid & 31;
  int bh, kt;  // low key tiles walk the most causal query steps
  if (!block_work(n_bh, (seq_len + BK - 1) / BK, bh, kt)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int k0 = kt * BK;
  const int qt0 = causal ? k0 / BQ : 0;  // earlier query steps see none of these keys
  const int n_steps = (seq_len + BQ - 1) / BQ - qt0;
  const Share<T> sh(dp, wg);
  constexpr bool kRes = C::kResident;
  const int s_items = kRes ? sh.nc : 2 * sh.nc;  // a step's S items
  // bf16 with the warpgroup's units its own chunks (a head dim up to 256):
  // the unit products read dO and Q from the step's S items, which stay in
  // their stages until then, and no unit item is loaded
  const bool fused = kRes && sh.u0 == sh.c0 && sh.nu == sh.nc;
  const int per_step = s_items + (fused ? 0 : 2 * sh.nu);
  unsigned char* res = smem + wg * C::kRes;       // bf16: K chunks, then V chunks
  uint64_t* res_bar = reinterpret_cast<uint64_t*>(smem + C::B::kBars) + 2 * NS + wg;
  float* xbuf = reinterpret_cast<float*>(smem + C::B::kXOff);
  Ring<NS, C::kStage> ring{smem + C::B::kRings + wg * C::B::kRing,
                           reinterpret_cast<uint64_t*>(smem + C::B::kBars) + wg * NS,
                           n_steps * per_step, 0};
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();
  init_ring(ring.full, NS, tid);
  if (kRes && tid == 0) {
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // per step: bf16 (Q, dO) of each chunk, f32 (K, Q) and (V, dO) of each
  // chunk; then dO's and Q's unit of each unit
  auto issue = [&](int i) {
    const int s = i / per_step, j = i % per_step;
    const int q0 = (qt0 + s) * BQ;
    unsigned char* st = ring.stage(i);
    uint64_t* bar = ring.bar(i);
    if (j < s_items) {
      mbar_expect_tx(bar, C::kSItem);
      if constexpr (kRes) {
        const int col = (sh.c0 + j) * R::kChunk;
        tma_load(st, &maps.q[0], bar, col, h, q0, b);
        tma_load(st + C::kQTile, &maps.dout[0], bar, col, h, q0, b);
      } else {
        const int col = (sh.c0 + j / 2) * R::kChunk;
        load_rows<R::kPlanes, BK>(j & 1 ? maps.v : maps.k, st, bar, col, h, k0, b);
        load_rows<R::kPlanes, BQ>(j & 1 ? maps.dout : maps.q, st + C::kKTile, bar, col, h, q0,
                                  b);
      }
    } else {
      const int jj = j - s_items, u = sh.u0 + jj / 2;
      mbar_expect_tx(bar, C::kUItem);
      if constexpr (R::kPlanes == 1)
        tma_load(st, jj & 1 ? &maps.q[0] : &maps.dout[0], bar, kUnit * u, h, q0, b);
      else
        load_t<BQ>(jj & 1 ? maps.qt : maps.dot, st, bar, u, h, q0, b);
    }
  };
  if (tid == 0) {
    if constexpr (kRes) {
      mbar_expect_tx(res_bar, 2 * sh.nc * kBox);
      for (int c = 0; c < sh.nc; ++c) {
        tma_load(res + c * kBox, &maps.k[0], res_bar, (sh.c0 + c) * R::kChunk, h, k0, b);
        tma_load(res + (4 + c) * kBox, &maps.v[0], res_bar, (sh.c0 + c) * R::kChunk, h, k0, b);
      }
    }
    for (int i = 0; i < NS && i < ring.total; ++i) issue(i);
  }
  if constexpr (kRes) mbar_wait(res_bar, 0);

  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = scale * kLog2e;
  const long long lrow = (long long)bh * seq_len;
  float acc_dk[kWgUnits][32], acc_dv[kWgUnits][32], st[BQ / 2], dpt[BQ / 2];
  AOps<T, BQ / 2> pa{}, da{};
#pragma unroll
  for (int j = 0; j < kWgUnits; ++j) {
    zero(acc_dk[j]);
    zero(acc_dv[j]);
  }
  zero(st);
  zero(dpt);
  auto settle = [&]() {
#pragma unroll
    for (int j = 0; j < kWgUnits; ++j) {
      fence_regs(acc_dk[j]);
      fence_regs(acc_dv[j]);
    }
    fence_regs(st);
    fence_regs(dpt);
    pa.fence();
    da.fence();
  };

  int i = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int q0 = (qt0 + s) * BQ;
    // lse (log2 units) and delta of this thread's queries q0 + 8j + 2t + c
    float lq[BQ / 4], dl[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + 8 * j + 2 * t + c;
        lq[2 * j + c] = q < seq_len ? __ldg(lse + lrow + q) * kLog2e : 0.f;
        dl[2 * j + c] = q < seq_len ? __ldg(delta + lrow + q) : 0.f;
      }
    // this warpgroup's half of S^T = K Q^T and dP^T = V dO^T, keys as rows
    for (int j = 0; j < s_items; ++j, ++i) {
      ring.room(i, wg, tid, issue);
      ring.wait(i);
      const unsigned char* stg = ring.stage(i);
      wgmma_fence();
      if constexpr (kRes) {
        chunk_product<T>(st, res + j * kBox, stg, 0, j == 0);
        chunk_product<T>(dpt, res + (4 + j) * kBox, stg + C::kQTile, 0, j == 0);
      } else if (j & 1) {
        chunk_product<T>(dpt, stg, stg + C::kKTile, BQ * 128, j == 1);
      } else {
        chunk_product<T>(st, stg, stg + C::kKTile, BQ * 128, j == 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    settle();
    if (!fused) ring.release(i, wg, tid, issue);
    exchange(st, dpt, xbuf, wg, tid);

    // P^T in place of S^T and dS^T (without the scale, which dK takes once
    // at the end) in place of dP^T; element 4j + e is key key0 + 8(e >> 1),
    // query q0 + 8j + 2t + (e & 1)
    const bool edge = (causal && q0 < k0 + BK - 1) || q0 + BQ > seq_len;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2_ftz(st[4 * j + e] * scale_log2 - lq[2 * j + (e & 1)]);
        if (edge) {
          const int q = q0 + 8 * j + 2 * t + (e & 1), key = key0 + 8 * (e >> 1);
          if (q >= seq_len || (causal && key > q)) pe = 0.f;
        }
        st[4 * j + e] = pe;
        dpt[4 * j + e] = pe * (dpt[4 * j + e] - dl[2 * j + (e & 1)]);
      }
    pa.make(st);
    da.make(dpt);
    // dV += P^T dO and dK += dS^T Q, unit by unit, then landed before the
    // next step's products are issued (issuing them behind these, which
    // their accumulators would allow, makes the compiler serialize every
    // wgmma of the kernel)
    if (fused) {
      // unit j is chunk j: its S item, j items back from the step's end
#pragma unroll
      for (int j = 0; j < kWgUnits; ++j) {
        if (j < sh.nu) {
          const unsigned char* stg = ring.stage(i - sh.nc + j);
          wgmma_fence();
          unit_product<T, BQ>(acc_dv[j], pa, stg + C::kQTile, 0);
          unit_product<T, BQ>(acc_dk[j], da, stg, 0);
          wgmma_commit();
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kWgUnits; ++j) {
        if (j < sh.nu) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            ring.room(i, wg, tid, issue);
            ring.wait(i);
            const unsigned char* stg = ring.stage(i);
            wgmma_fence();
            if (x == 0)
              unit_product<T, BQ>(acc_dv[j], pa, stg, (BQ / 32) * kBox);
            else
              unit_product<T, BQ>(acc_dk[j], da, stg, (BQ / 32) * kBox);
            wgmma_commit();
            ++i;
          }
        }
      }
    }
    wgmma_wait<0>();
    settle();
    if (fused) ring.release(i, wg, tid, issue);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= seq_len) continue;
    const long long row = (((long long)b * seq_len + key) * heads + h) * dp;
#pragma unroll
    for (int j = 0; j < kWgUnits; ++j) {
      if (j >= sh.nu) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = kUnit * (sh.u0 + j) + 8 * c + 2 * t;
        store2(dk + row + col, acc_dk[j][4 * c + 2 * r] * scale,
               acc_dk[j][4 * c + 2 * r + 1] * scale);
        store2(dv + row + col, acc_dv[j][4 * c + 2 * r], acc_dv[j][4 * c + 2 * r + 1]);
      }
    }
  }
}

struct DqMaps {
  // natural: Q and dO of 64 rows, K and V of kBK rows; f32 also K^T
  // (transposed planes, boxes of 32 keys); bf16 reads its units from k
  CUtensorMap q[2], k[2], dout[2], v[2], kt[2];
};

// dQ of one 64-query tile of one (b, h), units [4z, 4z + 4). Thread
// (warp w, lane 4g + t) of a warpgroup owns queries 16w + g and
// 16w + g + 8; its S and dP accumulators hold keys 8j + 2t and
// 8j + 2t + 1, its dQ accumulators columns 8j + 2t and 8j + 2t + 1 of each
// unit.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rows_dq_wgmma_kernel(const __grid_constant__ DqMaps maps, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, int n_bh, int seq_len,
                     int heads, int dp, float scale, int causal) {
  using C = DqCfg<T>;
  using R = Route<T>;
  constexpr int BQ = C::kBQ, BK = C::kBK, NS = C::B::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = warpgroup(), tid = threadIdx.x % kWg, warp = tid >> 5, lane = tid & 31;
  int bh, rank;  // high query tiles walk the most key steps
  const int n_qt = (seq_len + BQ - 1) / BQ;
  if (!block_work(n_bh, n_qt, bh, rank)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (n_qt - 1 - rank) * BQ;
  int n_kt = (seq_len + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);  // later steps fully masked
  const Share<T> sh(dp, wg);
  constexpr bool kRes = C::kResident;
  const int s_items = kRes ? sh.nc : 2 * sh.nc;  // a step's S items
  // bf16 with the warpgroup's units its own chunks (a head dim up to 256):
  // the unit products read K from the step's S items (as the dK/dV kernel)
  const bool fused = kRes && sh.u0 == sh.c0 && sh.nu == sh.nc;
  const int per_step = s_items + (fused ? 0 : sh.nu);
  unsigned char* res = smem + wg * C::kRes;       // bf16: Q chunks, then dO chunks
  uint64_t* res_bar = reinterpret_cast<uint64_t*>(smem + C::B::kBars) + 2 * NS + wg;
  float* xbuf = reinterpret_cast<float*>(smem + C::B::kXOff);
  Ring<NS, C::kStage> ring{smem + C::B::kRings + wg * C::B::kRing,
                           reinterpret_cast<uint64_t*>(smem + C::B::kBars) + wg * NS,
                           n_kt * per_step, 0};
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();
  init_ring(ring.full, NS, tid);
  if (kRes && tid == 0) {
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // per step: bf16 (K, V) of each chunk, f32 (Q, K) and (dO, V) of each
  // chunk; then K's unit of each unit
  auto issue = [&](int i) {
    const int s = i / per_step, j = i % per_step;
    unsigned char* st = ring.stage(i);
    uint64_t* bar = ring.bar(i);
    if (j < s_items) {
      mbar_expect_tx(bar, C::kSItem);
      if constexpr (kRes) {
        const int col = (sh.c0 + j) * R::kChunk;
        tma_load(st, &maps.k[0], bar, col, h, s * BK, b);
        tma_load(st + C::kKTile, &maps.v[0], bar, col, h, s * BK, b);
      } else {
        const int col = (sh.c0 + j / 2) * R::kChunk;
        load_rows<R::kPlanes, BQ>(j & 1 ? maps.dout : maps.q, st, bar, col, h, q0, b);
        load_rows<R::kPlanes, BK>(j & 1 ? maps.v : maps.k, st + C::kQTile, bar, col, h, s * BK,
                                  b);
      }
    } else {
      const int u = sh.u0 + j - s_items;
      mbar_expect_tx(bar, C::kUItem);
      if constexpr (R::kPlanes == 1)
        tma_load(st, &maps.k[0], bar, kUnit * u, h, s * BK, b);
      else
        load_t<BK>(maps.kt, st, bar, u, h, s * BK, b);
    }
  };
  if (tid == 0) {
    if constexpr (kRes) {
      mbar_expect_tx(res_bar, 2 * sh.nc * kBox);
      for (int c = 0; c < sh.nc; ++c) {
        tma_load(res + c * kBox, &maps.q[0], res_bar, (sh.c0 + c) * R::kChunk, h, q0, b);
        tma_load(res + (4 + c) * kBox, &maps.dout[0], res_bar, (sh.c0 + c) * R::kChunk, h, q0,
                 b);
      }
    }
    for (int i = 0; i < NS && i < ring.total; ++i) issue(i);
  }
  if constexpr (kRes) mbar_wait(res_bar, 0);

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's queries: row0, row0 + 8
  const float scale_log2 = scale * kLog2e;
  const long long lrow = (long long)bh * seq_len;
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    lq[r] = q < seq_len ? lse[lrow + q] * kLog2e : 0.f;
    dl[r] = q < seq_len ? delta[lrow + q] : 0.f;
  }
  float acc_dq[kWgUnits][32], sc[BK / 2], dp_[BK / 2];
  AOps<T, BK / 2> da{};
#pragma unroll
  for (int j = 0; j < kWgUnits; ++j) zero(acc_dq[j]);
  zero(sc);
  zero(dp_);
  auto settle = [&]() {
#pragma unroll
    for (int j = 0; j < kWgUnits; ++j) fence_regs(acc_dq[j]);
    fence_regs(sc);
    fence_regs(dp_);
    da.fence();
  };

  int i = 0;
  for (int s = 0; s < n_kt; ++s) {
    // this warpgroup's half of S = Q K^T and dP = dO V^T
    for (int j = 0; j < s_items; ++j, ++i) {
      ring.room(i, wg, tid, issue);
      ring.wait(i);
      const unsigned char* stg = ring.stage(i);
      wgmma_fence();
      if constexpr (kRes) {
        chunk_product<T>(sc, res + j * kBox, stg, 0, j == 0);
        chunk_product<T>(dp_, res + (4 + j) * kBox, stg + C::kKTile, 0, j == 0);
      } else if (j & 1) {
        chunk_product<T>(dp_, stg, stg + C::kQTile, BK * 128, j == 1);
      } else {
        chunk_product<T>(sc, stg, stg + C::kQTile, BK * 128, j == 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    settle();
    if (!fused) ring.release(i, wg, tid, issue);
    exchange(sc, dp_, xbuf, wg, tid);

    // P, then dS (without the scale, which dQ takes once at the end) in
    // place of dP; element 4j + e is query row0 + 8(e >> 1), key k0 + 8j +
    // 2t + (e & 1)
    const int k0 = s * BK;
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > seq_len;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2_ftz(sc[4 * j + e] * scale_log2 - lq[e >> 1]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), q = row0 + 8 * (e >> 1);
          if (key >= seq_len || (causal && key > q)) pe = 0.f;
        }
        dp_[4 * j + e] = pe * (dp_[4 * j + e] - dl[e >> 1]);
      }
    da.make(dp_);
    // dQ += dS K, unit by unit, landed before the next step's products, as
    // in the dK/dV kernel
    if (fused) {
#pragma unroll
      for (int j = 0; j < kWgUnits; ++j) {
        if (j < sh.nu) {
          const unsigned char* stg = ring.stage(i - sh.nc + j);
          wgmma_fence();
          unit_product<T, BK>(acc_dq[j], da, stg, 0);
          wgmma_commit();
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kWgUnits; ++j) {
        if (j < sh.nu) {
          ring.room(i, wg, tid, issue);
          ring.wait(i);
          const unsigned char* stg = ring.stage(i);
          wgmma_fence();
          unit_product<T, BK>(acc_dq[j], da, stg, (BK / 32) * kBox);
          wgmma_commit();
          ++i;
        }
      }
    }
    wgmma_wait<0>();
    settle();
    if (fused) ring.release(i, wg, tid, issue);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= seq_len) continue;
    T* out = dq + (((long long)b * seq_len + q) * heads + h) * dp;
#pragma unroll
    for (int j = 0; j < kWgUnits; ++j) {
      if (j >= sh.nu) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        store2(out + kUnit * (sh.u0 + j) + 8 * c + 2 * t, acc_dq[j][4 * c + 2 * r] * scale,
               acc_dq[j][4 * c + 2 * r + 1] * scale);
    }
  }
}

// ---- bf16 backward at 256 columns: 128 rows a block ---------------------------

// The bf16 backward at a padded head dim of 256 (D 193-256): the forward's
// pattern. A block's two warpgroups own 64 rows each of a 128-row tile
// (queries in the dQ kernel, keys in the dK/dV kernel) and each forms its
// rows' whole S and dP, so nothing is exchanged; the tile's Q and dO (K
// and V) stay resident and both warpgroups read every streamed tile of
// one shared ring, so each streamed byte serves 128 rows. dQ holds all
// four 64-column units (128 registers); dK and dV hold two each, so the
// dK/dV kernel takes two blocks a tile (grid z), each recomputing S^T
// and dP^T. Steps are 32 rows; P forms while dP is in flight, and each
// step's last products land before the next step's are issued (letting
// them run on under the next S and dP made ptxas serialize every wgmma).
constexpr int kBwd128Dp = 256;

template <int kRows, int kUnitsB>
struct Bwd128Cfg {
  static constexpr int kTile = 128, kStep = 32, kUnits = kUnitsB;
  static constexpr int kRes = 2 * kTile * kBwd128Dp * 2;   // two resident [128, 256] tiles
  static constexpr int kStage = kStep * kBwd128Dp * 2;     // one streamed [32, 256] tile
  static constexpr int kStages = (kSmem - kBarBytes - kRes) / kStage;
  static constexpr int kBars = kRes + kStages * kStage;
  static constexpr int kSmemBytes = kBars + kBarBytes;
  static_assert(kStages >= 3, "a step's two items and the next one's first in flight");
};
using Dq128Cfg = Bwd128Cfg<128, 4>;
using Dkdv128Cfg = Bwd128Cfg<128, 2>;

// A ring that a block's two warpgroups read in the same order: the second
// warpgroup to release an item refills its stage with the item kStages on
template <int kStages, int kStage>
struct SharedRing {
  unsigned char* base;
  uint64_t* full;
  unsigned* released;  // a count a stage: two a use
  int total;
  __device__ __forceinline__ unsigned char* stage(int i) const {
    return base + (i % kStages) * kStage;
  }
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(full + i % kStages, (i / kStages) & 1);
  }
  template <typename Issue>
  __device__ __forceinline__ void release(int i, int wg, int tid, Issue& issue) {
    wg_sync(wg);
    if (tid == 0 && (atomicAdd(&released[i % kStages], 1u) & 1u) && i + kStages < total)
      issue(i + kStages);
  }
};

struct Bwd128Maps {
  CUtensorMap res_a, res_b;    // the resident tiles: boxes of 128 rows
  CUtensorMap item_a, item_b;  // the streamed tiles: boxes of 32 rows
};

// Block set-up of both kernels: barriers, the resident tiles (a_map then
// b_map, rows r0 ..) and the ring's first items
template <typename C, typename Issue>
__device__ __forceinline__ SharedRing<C::kStages, C::kStage> bwd128_setup(
    unsigned char* smem, const Bwd128Maps& maps, int b, int h, int r0, int total,
    Issue& issue_of) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* res_bar = full + C::kStages;
  unsigned* released = reinterpret_cast<unsigned*>(res_bar + 1);
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzle's 1024-byte boxes
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  SharedRing<C::kStages, C::kStage> ring{smem + C::kRes, full, released, total};
  if (threadIdx.x == 0) {
    mbar_expect_tx(res_bar, C::kRes);
#pragma unroll
    for (int c = 0; c < kBwd128Dp / 64; ++c) {
      tma_load(smem + c * C::kTile * 128, &maps.res_a, res_bar, 64 * c, h, r0, b);
      tma_load(smem + C::kRes / 2 + c * C::kTile * 128, &maps.res_b, res_bar, 64 * c, h, r0, b);
    }
    for (int i = 0; i < C::kStages && i < total; ++i) issue_of(ring, i);
  }
  mbar_wait(res_bar, 0);
  return ring;
}

// Thread 0: item i of a ring whose items alternate a_map's and b_map's
// 32-row tiles of step i / 2, rows r0 + 32 (i / 2)
__device__ __forceinline__ void bwd128_item(unsigned char* st, uint64_t* bar,
                                            const Bwd128Maps& maps, int i, int b, int h,
                                            int r0) {
  mbar_expect_tx(bar, Dq128Cfg::kStage);
#pragma unroll
  for (int c = 0; c < kBwd128Dp / 64; ++c)
    tma_load(st + c * 32 * 128, i & 1 ? &maps.item_b : &maps.item_a, bar, 64 * c, h,
             r0 + 32 * (i >> 1), b);
}

// A resident [128, 256] tile's 64 rows of warpgroup wg as K-major A, times
// a streamed [32, 256] item as K-major B, into d (N = 32)
__device__ __forceinline__ void bwd128_scores(float (&d)[16], const unsigned char* res, int wg,
                                              const unsigned char* item) {
#pragma unroll
  for (int c = 0; c < kBwd128Dp / 64; ++c)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0>(d, kdesc(res + c * 128 * 128 + wg * 64 * 128, ks),
                  kdesc(item + c * 32 * 128, ks), c > 0 || ks > 0);
}

// acc (64 columns) += A U, A the operands of a 32-row step, U column unit
// u of a streamed [32, 256] item read MN-major
__device__ __forceinline__ void bwd128_unit(float (&acc)[32], const AOps<bf16, 16>& a,
                                            const unsigned char* item, int u) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint64_t d = mndesc<32>(item + u * 32 * 128, kk);
    wgmma_rs<1>(acc, a.lo[kk], d);
    wgmma_rs<1>(acc, a.hi[kk], d);
  }
}

// dQ of one 128-query tile of one (b, h), all 256 columns. Thread (warp
// w, lane 4g + t) of warpgroup wg owns queries 64 wg + 16w + g and + 8;
// its S and dP accumulators hold keys 8j + 2t and 8j + 2t + 1 of the step.
__global__ void __launch_bounds__(kThreads, 1)
rows_dq128_kernel(const __grid_constant__ Bwd128Maps maps, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq, int n_bh, int seq_len,
                  int heads, float scale, int causal) {
  using C = Dq128Cfg;
  constexpr int BQ = C::kTile, BK = C::kStep, U = C::kUnits;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = warpgroup(), tid = threadIdx.x % kWg, warp = tid >> 5, lane = tid & 31;
  int bh, rank;  // high query tiles walk the most key steps
  const int n_qt = (seq_len + BQ - 1) / BQ;
  if (!block_work(n_bh, n_qt, bh, rank)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (n_qt - 1 - rank) * BQ;
  int n_ks = (seq_len + BK - 1) / BK;
  if (causal) n_ks = min(n_ks, (q0 + BQ + BK - 1) / BK);  // later steps fully masked
  // items: K(s) = 2s, V(s) = 2s + 1
  auto issue_of = [&](auto& r, int i) {
    bwd128_item(r.stage(i), r.full + i % C::kStages, maps, i, b, h, 0);
  };
  auto ring = bwd128_setup<C>(smem, maps, b, h, q0, 2 * n_ks, issue_of);
  auto issue = [&](int i) { issue_of(ring, i); };
  const unsigned char* q_res = smem;
  const unsigned char* do_res = smem + C::kRes / 2;

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * wg + warp * 16 + g;  // this thread's queries: row0, row0 + 8
  const float scale_log2 = scale * kLog2e;
  const long long lrow = (long long)bh * seq_len;
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    lq[r] = q < seq_len ? lse[lrow + q] * kLog2e : 0.f;
    dl[r] = q < seq_len ? delta[lrow + q] : 0.f;
  }
  float acc[U][32], sc[BK / 2], dp_[BK / 2];
  AOps<bf16, BK / 2> da{};
#pragma unroll
  for (int u = 0; u < U; ++u) zero(acc[u]);
  zero(sc);
  zero(dp_);
  for (int s = 0; s < n_ks; ++s) {
    const int k0 = s * BK;
    ring.wait(2 * s);
    ring.wait(2 * s + 1);
    wgmma_fence();
    bwd128_scores(sc, q_res, wg, ring.stage(2 * s));
    wgmma_commit();
    bwd128_scores(dp_, do_res, wg, ring.stage(2 * s + 1));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    // P, then dS (without the scale, which dQ takes once at the end) in
    // place of dP; element 4j + e is query row0 + 8(e >> 1), key k0 + 8j +
    // 2t + (e & 1)
    const bool edge = (causal && k0 + BK - 1 > q0 + 64 * wg) || k0 + BK > seq_len;
    float pe[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2_ftz(sc[4 * j + e] * scale_log2 - lq[e >> 1]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), q = row0 + 8 * (e >> 1);
          if (key >= seq_len || (causal && key > q)) x = 0.f;
        }
        pe[4 * j + e] = x;
      }
    wgmma_wait<0>();
    fence_regs(dp_);
    ring.release(2 * s + 1, wg, tid, issue);  // V
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) dp_[e] = pe[e] * (dp_[e] - dl[(e >> 1) & 1]);
    da.make(dp_);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < U; ++u) bwd128_unit(acc[u], da, ring.stage(2 * s), u);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < U; ++u) fence_regs(acc[u]);
    da.fence();
    ring.release(2 * s, wg, tid, issue);  // K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= seq_len) continue;
    bf16* out = dq + (((long long)b * seq_len + q) * heads + h) * kBwd128Dp;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        store2(out + kUnit * u + 8 * c + 2 * t, acc[u][4 * c + 2 * r] * scale,
               acc[u][4 * c + 2 * r + 1] * scale);
  }
}

// dK and dV of one 128-key tile of one (b, h), columns [128 z, 128 z +
// 128). Thread (warp w, lane 4g + t) of warpgroup wg owns keys 64 wg +
// 16w + g and + 8; its S^T and dP^T accumulators hold queries 8j + 2t and
// 8j + 2t + 1 of the step.
__global__ void __launch_bounds__(kThreads, 1)
rows_dkdv128_kernel(const __grid_constant__ Bwd128Maps maps, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int n_bh, int seq_len, int heads, float scale,
                    int causal) {
  using C = Dkdv128Cfg;
  constexpr int BK = C::kTile, BQ = C::kStep, U = C::kUnits;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = warpgroup(), tid = threadIdx.x % kWg, warp = tid >> 5, lane = tid & 31;
  int bh, kt;  // low key tiles walk the most causal query steps
  if (!block_work(n_bh, (seq_len + BK - 1) / BK, bh, kt)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int k0 = kt * BK;
  const int qs0 = causal ? k0 / BQ : 0;  // earlier query steps see none of these keys
  const int n_qs = (seq_len + BQ - 1) / BQ - qs0;
  // items: Q(s) = 2s, dO(s) = 2s + 1, rows from qs0 BQ
  auto issue_of = [&](auto& r, int i) {
    bwd128_item(r.stage(i), r.full + i % C::kStages, maps, i, b, h, qs0 * BQ);
  };
  auto ring = bwd128_setup<C>(smem, maps, b, h, k0, 2 * n_qs, issue_of);
  auto issue = [&](int i) { issue_of(ring, i); };
  const unsigned char* k_res = smem;
  const unsigned char* v_res = smem + C::kRes / 2;

  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 64 * wg + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = scale * kLog2e;
  const long long lrow = (long long)bh * seq_len;
  float acc_dk[U][32], acc_dv[U][32], st[BQ / 2], dpt[BQ / 2];
  AOps<bf16, BQ / 2> pa{}, da{};
#pragma unroll
  for (int u = 0; u < U; ++u) {
    zero(acc_dk[u]);
    zero(acc_dv[u]);
  }
  zero(st);
  zero(dpt);
  for (int s = 0; s < n_qs; ++s) {
    const int q0 = (qs0 + s) * BQ;
    // lse (log2 units) and delta of this thread's queries q0 + 8j + 2t + c
    float lq[BQ / 4], dl[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + 8 * j + 2 * t + c;
        lq[2 * j + c] = q < seq_len ? __ldg(lse + lrow + q) * kLog2e : 0.f;
        dl[2 * j + c] = q < seq_len ? __ldg(delta + lrow + q) : 0.f;
      }
    ring.wait(2 * s);
    ring.wait(2 * s + 1);
    wgmma_fence();
    bwd128_scores(st, k_res, wg, ring.stage(2 * s));
    wgmma_commit();
    bwd128_scores(dpt, v_res, wg, ring.stage(2 * s + 1));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    // P^T in place of S^T, then dS^T (without the scale, which dK takes
    // once at the end) in place of dP^T; element 4j + e is key key0 + 8(e
    // >> 1), query q0 + 8j + 2t + (e & 1)
    const bool edge = (causal && q0 < k0 + 64 * wg + 63) || q0 + BQ > seq_len;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2_ftz(st[4 * j + e] * scale_log2 - lq[2 * j + (e & 1)]);
        if (edge) {
          const int q = q0 + 8 * j + 2 * t + (e & 1), key = key0 + 8 * (e >> 1);
          if (q >= seq_len || (causal && key > q)) x = 0.f;
        }
        st[4 * j + e] = x;
      }
    pa.make(st);
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl[2 * j + (e & 1)]);
    da.make(dpt);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      bwd128_unit(acc_dv[u], pa, ring.stage(2 * s + 1), blockIdx.z * U + u);
      bwd128_unit(acc_dk[u], da, ring.stage(2 * s), blockIdx.z * U + u);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      fence_regs(acc_dk[u]);
      fence_regs(acc_dv[u]);
    }
    pa.fence();
    da.fence();
    ring.release(2 * s, wg, tid, issue);  // Q
    ring.release(2 * s + 1, wg, tid, issue);  // dO
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= seq_len) continue;
    const long long row = (((long long)b * seq_len + key) * heads + h) * kBwd128Dp;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = kUnit * (blockIdx.z * U + u) + 8 * c + 2 * t;
        store2(dk + row + col, acc_dk[u][4 * c + 2 * r] * scale,
               acc_dk[u][4 * c + 2 * r + 1] * scale);
        store2(dv + row + col, acc_dv[u][4 * c + 2 * r], acc_dv[u][4 * c + 2 * r + 1]);
      }
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], in f32: one warp
// per row, eight rows a block
template <typename T>
__global__ void __launch_bounds__(256)
rows_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                  Strides os, Strides dos, int batch, int seq_len, int heads, int dp) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * seq_len * heads) return;
  const int h = (int)(row % heads);
  const int t = (int)((row / heads) % seq_len);
  const int b = (int)(row / ((long long)heads * seq_len));
  const T* orow = o + b * os.b + t * os.t + h * os.h;
  const T* drow = dout + b * dos.b + t * dos.t + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < dp; d += 32) acc += load1(orow + d) * load1(drow + d);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[((long long)b * heads + h) * seq_len + t] = acc;
}

// The f32 pre-pass over one [B, T, H, Dp] operand (element strides `st`):
// x = hi + lo as TF32 values (`split`), written as natural planes
// [B, T, H, Dp] (`nat`, hi then lo, when given) and as transposed planes
// [B, H, Dp, Tp] with rows at kpos(t) and zeros for t >= T (`tr`, when
// given). A block is one 32 x 32 (t, d) tile of one (b, h), transposed
// through shared memory; grid x = (b, h) x t tiles, grid y = d tiles.
__device__ __forceinline__ void split_tile(const float* __restrict__ x, Strides st, int seq_len,
                                           int heads, int dp, int tp, float* __restrict__ nat,
                                           float* __restrict__ tr) {
  __shared__ float tile[2][32][33];
  const int n_tt = tp / 32;
  const int bh = blockIdx.x / n_tt, t0 = (blockIdx.x % n_tt) * 32, d0 = blockIdx.y * 32;
  const int b = bh / heads, h = bh % heads;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long n_nat = (long long)gridDim.x / n_tt * seq_len * dp;  // one natural plane
  for (int r = ty; r < 32; r += 8) {
    const int t = t0 + r, d = d0 + tx;
    uint32_t hi = 0, lo = 0;
    if (t < seq_len) {
      split(x[b * st.b + t * st.t + h * st.h + d], hi, lo);
      if (nat != nullptr) {
        const long long at = (((long long)b * seq_len + t) * heads + h) * dp + d;
        nat[at] = __uint_as_float(hi);
        nat[n_nat + at] = __uint_as_float(lo);
      }
    }
    tile[0][r][tx] = __uint_as_float(hi);
    tile[1][r][tx] = __uint_as_float(lo);
  }
  if (tr == nullptr) return;
  __syncthreads();
  const long long n_tr = (long long)gridDim.x / n_tt * dp * tp;  // one transposed plane
  for (int r = ty; r < 32; r += 8) {
    const long long at = ((long long)bh * dp + d0 + r) * tp + kpos(t0 + tx);
    tr[at] = tile[0][tx][r];
    tr[n_tr + at] = tile[1][tx][r];
  }
}

__global__ void __launch_bounds__(256)
rows_fwd_split_kernel(const float* __restrict__ x, Strides st, int seq_len, int heads, int dp,
                      int tp, float* __restrict__ nat, float* __restrict__ tr) {
  split_tile(x, st, seq_len, heads, dp, tp, nat, tr);
}

__global__ void __launch_bounds__(256)
rows_bwd_split_kernel(const float* __restrict__ x, Strides st, int seq_len, int heads, int dp,
                      int tp, float* __restrict__ nat, float* __restrict__ tr) {
  split_tile(x, st, seq_len, heads, dp, tp, nat, tr);
}

// ---- host side ------------------------------------------------------------------

int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Rows rounded up to a tile of 64: the transposed planes' row count
int padded_rows(int seq_len) { return (seq_len + 63) / 64 * 64; }

dim3 rows_grid(int n_bh, int seq_len, int dp) {
  dim3 g = work_grid(n_bh, (seq_len + 63) / 64);
  g.z = (unsigned)((dp / kUnit + kBlockUnits - 1) / kBlockUnits);
  return g;
}

// An f32 [B, T, H, Dp] plane pair (hi, lo), contiguous, as TMA maps of
// boxes of 32 columns and `rows` rows
int nat_maps(CUtensorMap* maps, const float* planes, int B, int T, int H, int dp, int rows) {
  const long long n = (long long)B * T * H * dp;
  const Strides st{(long long)T * H * dp, (long long)H * dp, dp};
  int rc = encode<float>(&maps[0], planes, B, T, H, dp, st, 32, rows);
  if (rc == 0) rc = encode<float>(&maps[1], planes + n, B, T, H, dp, st, 32, rows);
  return rc;
}

// A transposed f32 plane pair [B, H, Dp, Tp] as TMA maps whose box is 32
// rows (keys or queries) of 64 columns: dims (Tp, H, Dp, B)
int tr_maps(CUtensorMap* maps, const float* planes, int B, int H, int dp, int tp) {
  const long long n = (long long)B * H * dp * tp;
  const Strides st{(long long)H * dp * tp, tp, (long long)dp * tp};
  int rc = encode<float>(&maps[0], planes, B, dp, H, tp, st, 32, kUnit);
  if (rc == 0) rc = encode<float>(&maps[1], planes + n, B, dp, H, tp, st, 32, kUnit);
  return rc;
}

void split_planes(const float* x, Strides st, int B, int T, int H, int dp, float* nat,
                  float* tr, bool fwd, cudaStream_t stream) {
  const int tp = padded_rows(T);
  const dim3 grid((unsigned)((long long)B * H * (tp / 32)), (unsigned)(dp / 32));
  if (fwd)
    rows_fwd_split_kernel<<<grid, 256, 0, stream>>>(x, st, T, H, dp, tp, nat, tr);
  else
    rows_bwd_split_kernel<<<grid, 256, 0, stream>>>(x, st, T, H, dp, tp, nat, tr);
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *out, *dq, *dk, *dv, *delta;
  float* scratch;
  int batch, seq_len, heads, dp;
  Strides qs, ks, vs, os, dos;
  float scale;
  int causal;
  cudaStream_t stream;
};

int fwd_f32(const Args& a) {
  using C = FwdCfg;
  const int B = a.batch, T_ = a.seq_len, H = a.heads, dp = a.dp;
  const long long n = (long long)B * T_ * H * dp;
  float* qn = a.scratch;  // Q hi, lo; K hi, lo; V^T hi, lo
  float* kn = qn + 2 * n;
  float* vt = kn + 2 * n;
  split_planes(static_cast<const float*>(a.q), a.qs, B, T_, H, dp, qn, nullptr, true, a.stream);
  split_planes(static_cast<const float*>(a.k), a.ks, B, T_, H, dp, kn, nullptr, true, a.stream);
  split_planes(static_cast<const float*>(a.v), a.vs, B, T_, H, dp, nullptr, vt, true, a.stream);
  FwdMaps m;
  int rc = nat_maps(m.q, qn, B, T_, H, dp, C::kBQ);
  if (rc == 0) rc = nat_maps(m.k, kn, B, T_, H, dp, C::kBK);
  if (rc == 0) rc = tr_maps(m.v, vt, B, H, dp, padded_rows(T_));
  if (rc == 0) rc = set_smem((const void*)rows_fwd_wgmma_kernel, C::B::kSmemBytes);
  if (rc != 0) return rc;
  rows_fwd_wgmma_kernel<<<rows_grid(B * H, T_, dp), kThreads, C::B::kSmemBytes, a.stream>>>(
      m, static_cast<float*>(a.out), static_cast<float*>(const_cast<void*>(a.lse)), B * H, T_,
      H, dp, (float)(a.scale * kLog2e), a.causal);
  return (int)cudaGetLastError();
}

template <int DP>
int fwd_bf16(const Args& a) {
  using C = Bf16FwdCfg<DP>;
  const int B = a.batch, T_ = a.seq_len, H = a.heads;
  Bf16FwdMaps m;
  int rc = encode<bf16>(&m.q, a.q, B, T_, H, DP, a.qs, 64, C::kBQ);
  if (rc == 0) rc = encode<bf16>(&m.k, a.k, B, T_, H, DP, a.ks, 64, C::kBK);
  if (rc == 0) rc = encode<bf16>(&m.v, a.v, B, T_, H, DP, a.vs, 64, C::kBK);
  if (rc == 0) rc = set_smem((const void*)rows_fwd_bf16_kernel<DP>, C::kSmemBytes);
  if (rc != 0) return rc;
  dim3 grid = work_grid(B * H, (T_ + C::kBQ - 1) / C::kBQ);
  grid.z = C::kZ;
  rows_fwd_bf16_kernel<DP><<<grid, kThreads, C::kSmemBytes, a.stream>>>(
      m, static_cast<bf16*>(a.out), static_cast<float*>(const_cast<void*>(a.lse)), B * H, T_, H,
      (float)(a.scale * kLog2e), a.causal);
  return (int)cudaGetLastError();
}

// The bf16 backward at 256 columns: delta, dK and dV (two blocks a
// 128-key tile), dQ (one a 128-query tile)
int bwd128(const Args& a) {
  const int B = a.batch, T_ = a.seq_len, H = a.heads, dp = kBwd128Dp;
  Bwd128Maps mk, mq;
  int rc = encode<bf16>(&mk.res_a, a.k, B, T_, H, dp, a.ks, 64, 128);
  if (rc == 0) rc = encode<bf16>(&mk.res_b, a.v, B, T_, H, dp, a.vs, 64, 128);
  if (rc == 0) rc = encode<bf16>(&mk.item_a, a.q, B, T_, H, dp, a.qs, 64, 32);
  if (rc == 0) rc = encode<bf16>(&mk.item_b, a.dout, B, T_, H, dp, a.dos, 64, 32);
  if (rc == 0) rc = encode<bf16>(&mq.res_a, a.q, B, T_, H, dp, a.qs, 64, 128);
  if (rc == 0) rc = encode<bf16>(&mq.res_b, a.dout, B, T_, H, dp, a.dos, 64, 128);
  if (rc == 0) rc = encode<bf16>(&mq.item_a, a.k, B, T_, H, dp, a.ks, 64, 32);
  if (rc == 0) rc = encode<bf16>(&mq.item_b, a.v, B, T_, H, dp, a.vs, 64, 32);
  if (rc == 0) rc = set_smem((const void*)rows_dkdv128_kernel, Dkdv128Cfg::kSmemBytes);
  if (rc == 0) rc = set_smem((const void*)rows_dq128_kernel, Dq128Cfg::kSmemBytes);
  if (rc != 0) return rc;
  const long long rows = (long long)B * T_ * H;
  rows_delta_kernel<bf16><<<(unsigned)((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<float*>(a.delta), a.os, a.dos, B, T_, H, dp);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  dim3 grid = work_grid(B * H, (T_ + 127) / 128);
  grid.z = 2;
  rows_dkdv128_kernel<<<grid, kThreads, Dkdv128Cfg::kSmemBytes, a.stream>>>(
      mk, lse, delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), B * H, T_, H,
      a.scale, a.causal);
  grid.z = 1;
  rows_dq128_kernel<<<grid, kThreads, Dq128Cfg::kSmemBytes, a.stream>>>(
      mq, lse, delta, static_cast<bf16*>(a.dq), B * H, T_, H, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const Args& a) {
  using K = DkdvCfg<T>;
  using Q = DqCfg<T>;
  const int B = a.batch, T_ = a.seq_len, H = a.heads, dp = a.dp;
  DkdvMaps mk;
  DqMaps mq;
  int rc = 0;
  if constexpr (Route<T>::kPlanes == 1) {
    rc = encode<bf16>(&mk.k[0], a.k, B, T_, H, dp, a.ks, 64, K::kBK);
    if (rc == 0) rc = encode<bf16>(&mk.v[0], a.v, B, T_, H, dp, a.vs, 64, K::kBK);
    if (rc == 0) rc = encode<bf16>(&mk.q[0], a.q, B, T_, H, dp, a.qs, 64, K::kBQ);
    if (rc == 0) rc = encode<bf16>(&mk.dout[0], a.dout, B, T_, H, dp, a.dos, 64, K::kBQ);
    if (rc == 0) rc = encode<bf16>(&mq.q[0], a.q, B, T_, H, dp, a.qs, 64, Q::kBQ);
    if (rc == 0) rc = encode<bf16>(&mq.dout[0], a.dout, B, T_, H, dp, a.dos, 64, Q::kBQ);
    if (rc == 0) rc = encode<bf16>(&mq.k[0], a.k, B, T_, H, dp, a.ks, 64, Q::kBK);
    if (rc == 0) rc = encode<bf16>(&mq.v[0], a.v, B, T_, H, dp, a.vs, 64, Q::kBK);
  } else {
    const long long n = (long long)B * T_ * H * dp, nt = (long long)B * H * dp * padded_rows(T_);
    // natural Q, K, V, dO, then transposed Q, dO, K: hi and lo each
    float* qn = a.scratch;
    float* kn = qn + 2 * n;
    float* vn = kn + 2 * n;
    float* don = vn + 2 * n;
    float* qt = don + 2 * n;
    float* dot = qt + 2 * nt;
    float* kt = dot + 2 * nt;
    split_planes(static_cast<const float*>(a.q), a.qs, B, T_, H, dp, qn, qt, false, a.stream);
    split_planes(static_cast<const float*>(a.k), a.ks, B, T_, H, dp, kn, kt, false, a.stream);
    split_planes(static_cast<const float*>(a.v), a.vs, B, T_, H, dp, vn, nullptr, false, a.stream);
    split_planes(static_cast<const float*>(a.dout), a.dos, B, T_, H, dp, don, dot, false, a.stream);
    const int tp = padded_rows(T_);
    rc = nat_maps(mk.k, kn, B, T_, H, dp, K::kBK);
    if (rc == 0) rc = nat_maps(mk.v, vn, B, T_, H, dp, K::kBK);
    if (rc == 0) rc = nat_maps(mk.q, qn, B, T_, H, dp, K::kBQ);
    if (rc == 0) rc = nat_maps(mk.dout, don, B, T_, H, dp, K::kBQ);
    if (rc == 0) rc = tr_maps(mk.qt, qt, B, H, dp, tp);
    if (rc == 0) rc = tr_maps(mk.dot, dot, B, H, dp, tp);
    if (rc == 0) rc = nat_maps(mq.q, qn, B, T_, H, dp, Q::kBQ);
    if (rc == 0) rc = nat_maps(mq.dout, don, B, T_, H, dp, Q::kBQ);
    if (rc == 0) rc = nat_maps(mq.k, kn, B, T_, H, dp, Q::kBK);
    if (rc == 0) rc = nat_maps(mq.v, vn, B, T_, H, dp, Q::kBK);
    if (rc == 0) rc = tr_maps(mq.kt, kt, B, H, dp, tp);
  }
  if (rc != 0) return rc;
  rc = set_smem((const void*)rows_dkdv_wgmma_kernel<T>, K::B::kSmemBytes);
  if (rc == 0) rc = set_smem((const void*)rows_dq_wgmma_kernel<T>, Q::B::kSmemBytes);
  if (rc != 0) return rc;
  const long long rows = (long long)B * T_ * H;
  rows_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), static_cast<float*>(a.delta),
      a.os, a.dos, B, T_, H, dp);
  const dim3 grid = rows_grid(B * H, T_, dp);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  rows_dkdv_wgmma_kernel<T><<<grid, kThreads, K::B::kSmemBytes, a.stream>>>(
      mk, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), B * H, T_, H, dp, a.scale,
      a.causal);
  rows_dq_wgmma_kernel<T><<<grid, kThreads, Q::B::kSmemBytes, a.stream>>>(
      mq, lse, delta, static_cast<T*>(a.dq), B * H, T_, H, dp, a.scale, a.causal);
  return (int)cudaGetLastError();
}

bool takes(int dtype, int dp) {
  return (dtype == 0 || dtype == 1) && dp % kUnit == 0 && dp > 128 && dp <= 512;
}

template <typename C>
void plan_of(int* out) {
  out[0] = C::kStage;
  out[1] = C::B::kStages;
  out[2] = (C::B::kBars - C::B::kXOff) / 2;  // a warpgroup's exchange buffer
  out[3] = C::B::kSmemBytes;
}

// The plan of a kernel with resident tiles and one shared ring
template <typename C>
void shared_plan_of(int* out) {
  out[0] = C::kStage;
  out[1] = C::kStages;
  out[2] = C::kRes;
  out[3] = C::kSmemBytes;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; dp the head dim padded to a multiple
// of 64 from 192 to 512 (bf16: 192, 256, 384 or 512). q, k, v are [B, T,
// H, dp] views with unit-stride dp (element strides given) whose base and
// strides are 16-byte multiples; o is contiguous [B, T, H, dp] in the
// input dtype, lse contiguous f32 [B, H, T]. f32 takes `scratch`, 4 [B,
// T, H, dp] planes and 2 [B, H, dp, T rounded up to 64] (the wrapper's
// `rows_scratch`); bf16 none. Returns 0 on success, else a CUDA error
// code or a tensor-map code of hopper.cuh.
int flash_rows_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                   void* scratch, int dtype, int batch, int seq_len, int heads, int dp,
                   long long q_sb, long long q_st, long long q_sh, long long k_sb,
                   long long k_st, long long k_sh, long long v_sb, long long v_st,
                   long long v_sh, float scale, int causal, void* stream) {
  if (!takes(dtype, dp)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.out = o, a.lse = lse;
  a.scratch = static_cast<float*>(scratch);
  a.batch = batch, a.seq_len = seq_len, a.heads = heads, a.dp = dp;
  a.qs = Strides{q_sb, q_st, q_sh}, a.ks = Strides{k_sb, k_st, k_sh}, a.vs = Strides{v_sb, v_st, v_sh};
  a.scale = scale, a.causal = causal, a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_f32(a);
  switch (dp) {
    case 192: return fwd_bf16<192>(a);
    case 256: return fwd_bf16<256>(a);
    case 384: return fwd_bf16<384>(a);
    case 512: return fwd_bf16<512>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward: q, k, v, o and dout [B, T, H, dp] views as above, lse f32
// contiguous [B, H, T]; delta f32 [B, H, T] is scratch; dq, dk, dv
// contiguous [B, T, H, dp] in the input dtype; f32 takes `scratch`, 8
// natural planes and 6 transposed (`rows_scratch`). Launches on the
// stream: the f32 pre-pass (four splits), delta, dK and dV, then dQ.
int flash_rows_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dout, void* dq, void* dk, void* dv, void* delta, void* scratch,
                   int dtype, int batch, int seq_len, int heads, int dp, long long q_sb,
                   long long q_st, long long q_sh, long long k_sb, long long k_st,
                   long long k_sh, long long v_sb, long long v_st, long long v_sh,
                   long long o_sb, long long o_st, long long o_sh, long long do_sb,
                   long long do_st, long long do_sh, float scale, int causal, void* stream) {
  if (!takes(dtype, dp)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.lse = lse, a.dout = dout;
  a.dq = dq, a.dk = dk, a.dv = dv, a.delta = delta;
  a.scratch = static_cast<float*>(scratch);
  a.batch = batch, a.seq_len = seq_len, a.heads = heads, a.dp = dp;
  a.qs = Strides{q_sb, q_st, q_sh}, a.ks = Strides{k_sb, k_st, k_sh}, a.vs = Strides{v_sb, v_st, v_sh};
  a.os = Strides{o_sb, o_st, o_sh}, a.dos = Strides{do_sb, do_st, do_sh};
  a.scale = scale, a.causal = causal, a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(a);
  return dp == kBwd128Dp ? bwd128(a) : bwd<bf16>(a);
}

// The design's numbers for (dtype, kernel: 0 forward, 1 dK/dV, 2 dQ) at
// padded head dim dp (read by bf16 alone): stage bytes, stages a
// warpgroup (bf16's 128-row kernels: a block's shared ring), exchange
// bytes a warpgroup (the 128-row kernels: the resident tiles' bytes),
// shared memory a block; returns the output columns a unit
int flash_rows_plan(int dtype, int kernel, int dp, int* out) {
  if (dtype == 0) {
    if (kernel == 0) plan_of<FwdCfg>(out);
    if (kernel == 1) plan_of<DkdvCfg<float>>(out);
    if (kernel == 2) plan_of<DqCfg<float>>(out);
  } else {
    if (kernel == 0) {
      if (dp == 192) shared_plan_of<Bf16FwdCfg<192>>(out);
      if (dp == 256) shared_plan_of<Bf16FwdCfg<256>>(out);
      if (dp == 384) shared_plan_of<Bf16FwdCfg<384>>(out);
      if (dp == 512) shared_plan_of<Bf16FwdCfg<512>>(out);
    }
    if (kernel == 1 && dp == kBwd128Dp) shared_plan_of<Dkdv128Cfg>(out);
    if (kernel == 2 && dp == kBwd128Dp) shared_plan_of<Dq128Cfg>(out);
    if (kernel == 1 && dp != kBwd128Dp) plan_of<DkdvCfg<bf16>>(out);
    if (kernel == 2 && dp != kBwd128Dp) plan_of<DqCfg<bf16>>(out);
  }
  return kUnit;
}

const char* flash_rows_error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
