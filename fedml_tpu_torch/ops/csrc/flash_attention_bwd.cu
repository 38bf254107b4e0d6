// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's `_bwd` (fedml_tpu/ops/flash_attention.py:140-175),
// the custom_vjp backward of the Pallas `_flash_kernel`: a FlashAttention-2
// recompute from the forward's saved per-row log-sum-exp, never the dense
// [T, T] matrix. Same function, over [B, T, H, D] inputs (f32 or bf16, D in
// {16, 32, 64, 128}, causal or not, any T, any B*H):
//   delta = rowsum(dO * O)
//   P     = exp(scale * Q K^T - lse), masked entries exactly 0 (the
//           reference masks S with -1e30 before the exp)
//   dV = P^T dO,  dS = P * (dO V^T - delta) * scale,  dK = dS^T Q,  dQ = dS K
// Arithmetic and accumulation are f32, as `_bwd` does them; dQ, dK and dV
// are written in the input dtype, contiguous [B, T, H, D].
//
// Both routes launch three kernels on the caller's stream, none with
// floating-point atomics, so every output element is summed in one fixed
// order and two runs agree bitwise: `delta_kernel` (one warp per row), a
// key-tile-major dK/dV kernel that walks the query tiles from the causal
// start, and a query-tile-major dQ kernel that walks the key tiles up to
// the causal end. S and dP are computed in both: that is the price of
// having no atomics and no [T, T] scratch. The grid puts batch*head on x
// (up to 2^31 - 1) and the tile on y (tiles past y's 65,535 fold into x:
// `work_grid`, hopper.cuh), low key tiles and high query tiles
// (the longest causal walks) first: blocks start x-fastest.
//
// Bound on an H100: the five products do ~10*D flops per unmasked (query,
// key) pair against ~8 passes over [B, T, H, D] of bytes, so operations
// bound it, far above the card's balance point.
//
// bf16 route (the training path): `dkdv_wgmma_kernel` and
// `dq_wgmma_kernel`. What held the earlier design back, and what this one
// does about each:
// - Synchronous loads by every thread: now TMA loads (4-D tensor maps,
//   128/64/32-byte swizzle) run ahead through an mbarrier ring of two or
//   three stages. The dK/dV kernel keeps its K and V tiles resident and
//   streams Q and dO with the tile's lse and delta; the dQ kernel keeps Q
//   and dO and streams K and V. Rows past T arrive as TMA's zero fill and
//   are masked. The warpgroup feeds its own ring: when a tile is done,
//   thread 0 loads the tile `stages` ahead into its stage. A separate
//   producer warp would make a block five warps, which the register
//   allocator counts as six, so two blocks of 168 registers a thread
//   would fill an SM; without it three fit, and the third warpgroup hides
//   more of each one's serial chain (products, exponentials, hi/lo
//   splits).
// - Operands widened to f32 in shared memory: they stay bf16, in the
//   layout TMA writes and `wgmma` reads by descriptor (half the bytes).
// - TF32 `mma.sync` at half the bf16 rate, scalar fragment loads: every
//   product is `wgmma.mma_async` bf16 with f32 accumulators, issued by one
//   consumer warpgroup of 64 rows.
// - P and dS through shared memory, read back transposed: the dK/dV
//   kernel computes S^T = K Q^T and dP^T = V dO^T with keys as rows, so
//   P^T and dS^T form in its accumulators, and the accumulator layout is
//   `wgmma`'s register A layout: they feed dV += P^T dO and dK += dS^T Q
//   straight from registers, with B the dO or Q tile read MN-major (the
//   transpose bit). The dQ kernel does the same with dS in its own
//   orientation: dQ += dS K. Nothing of P or dS touches shared memory.
// - Accuracy is kept: Q, K, V and dO are exact bf16, so S and dP take one
//   pass each; P and dS are f32 and are split into bf16 hi + lo (hi =
//   bf16(x), lo = bf16(x - hi), ~2^-17 relative), so each product with
//   them is two passes into one accumulator, lo first. bf16 has f32's
//   exponent range, so dS cannot overflow.
// Passes: dK/dV 1 + 1 + 2 + 2 = 6 per tile pair, dQ 1 + 1 + 2 = 4: 10
// against the 5 that the bound counts, so this design's own floor is half
// the bound's rate (~2.78 ms at [32, 4096, 8, 64] causal, 1.390 ms bound).
// Tiles: 64 keys x 64 queries (32 queries in the dK/dV kernel at D 128,
// whose dK and dV accumulators take 128 registers), one warpgroup per
// block, three blocks per SM (two at D 128). The elementwise work sits
// beside in-flight products: P forms while dP is still computing, and
// each 16-wide k-step's hi/lo operands form while the previous step's
// products run. The softmax scale is applied to dK and dQ once at the
// end. `block_work` orders the blocks so that those in flight stream the
// tiles of a few heads, which stay in L2.
//
// f32 route (the reference's default dtype; serving's f32 and the f32
// training path): `dkdv_tf32_kernel` and `dq_tf32_kernel`, the bf16
// route's structure on TF32 `wgmma` (m64nNk8, f32 accumulators) with TMA
// loads. What held the earlier `mma.sync` design back (19% of the bound,
// slower than SDPA's backward), and what this one does about each:
// - TF32 `mma.sync` with fragments loaded by every thread, 8 warps a
//   block: every product is `wgmma.mma_async` .tf32 by a warpgroup of 64
//   rows. A block is two warpgroups that share the resident tiles (K and
//   V in the dK/dV kernel, Q and dO in the dQ kernel) and take the
//   streamed steps in turn, each with its own stage and its own partial
//   sums, added in one fixed order at the end (`combine_partials`): while
//   one warpgroup runs its staging pass or its softmax, the other's
//   products hold the tensor cores.
// - Synchronous loads by every thread into padded tiles: Q, K, V and dO
//   arrive by TMA (4-D tensor maps, 32-float boxes, 128-byte swizzle);
//   a warpgroup's next step is loaded into its stage as soon as the
//   step's natural tiles are read, while its dV/dK (or dQ) products run.
// - P and dS through shared memory, read back transposed: as in the bf16
//   route, the dK/dV kernel forms P^T and dS^T in its accumulators (keys
//   as rows) and the dQ kernel dS; they feed the next product as register
//   A operands. tf32 `wgmma` has no transpose bits (PTX allows them for
//   f16/bf16 only), so both shared-memory operands are K-major, and the
//   three products that contract over a tile's rows (dV += P^T dO and
//   dK += dS^T Q over queries, dQ += dS K over keys) read B from copies
//   that `transpose_tile` writes while the step's S and dP products run.
//   An accumulator reused as A holds columns 2t, 2t + 1 where A's k order
//   wants t, t + 4, so the transposed copies store row 2t at column t and
//   2t + 1 at t + 4 within each 8 (`kpos`): the permutation costs nothing
//   where the copy is written anyway.
// - Accuracy: 3xTF32 throughout, x = hi + lo with hi = tf32(x) and lo =
//   tf32(x - hi), both rounded to nearest (ties away), and three passes
//   into one accumulator, lo*hi + hi*lo + hi*hi. Every operand the tensor
//   cores read is an exact TF32 value, so how they treat the low 13 bits
//   does not matter. Where the split happens: `stage_tile`, one
//   thread-cooperative sweep over each tile TMA lands, rewrites it as hi
//   in place and writes lo beside it (the resident tiles once a block; Q
//   and dO a step in the dK/dV kernel, K and V a step in the dQ kernel);
//   `transpose_tile` copies Q's and dO's (dK/dV) and K's (dQ) hi and lo
//   transposed; P^T, dS^T and dS are split in registers. Where the
//   registers allow (`kDkdvRegA`, `kDqRegA`), the resident tiles' hi A
//   operands stay in registers for the block's life, so that the S and
//   dP products' two hi passes read only B from shared memory.
// - Passes: 7 products x 3 = 21 (S^T, dP^T, dV, dK; S, dP, dQ), against
//   the bound's 5 x 3 = 15: this design's floor is 21/15 of the bound,
//   2.92 ms at [8, 4096, 8, 64] causal (2.083 ms bound), 11.66 ms at [32,
//   4096, 8, 64] (8.332 ms).
// - Shared memory (227 KB a block) decides the tiles. The dK/dV kernel
//   keeps K hi/lo and V hi/lo resident (4 x 64 x D x 4 bytes) and a stage
//   holds Q and dO as hi, lo, transposed hi and transposed lo (8 x kQS x
//   D x 4) with the step's lse and delta; the dQ kernel keeps Q and dO
//   hi/lo and a stage holds K as hi, lo and transposed hi/lo and V as hi,
//   lo (6 x kKS x D x 4). Steps of kQS = 64 / 32 / 8 queries and kKS =
//   64 / 32 / 16 keys at D <= 32 / 64 / 128, one stage for each of the
//   two warpgroups, give 82-194 KB and 64-224 KB: one block an SM.
// - The softmax scale is applied to dK and dQ once, at the end; P is
//   exp2(S scale log2 e - lse log2 e), as in the bf16 route.
// What bounds it now is not the tensor cores alone. Reckoned from the
// code at D 64 (a dK/dV step of 32 queries): its staging and transposing
// passes, the S/dP products' lo pass from shared memory and the dV/dK
// products' B operands move ~240 KB of shared memory (~1,900 clocks at
// 128 bytes a clock) against ~1,500 clocks of TF32 products, and each
// thread issues ~870 instructions, with two warps a scheduler to hide
// their latency. PERF.md has the measurements.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWarps = 8;  // the delta kernel: one warp per row
constexpr int kThreads = kWarps * 32;

// ---- stores and loads shared by the routes ------------------------------------

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// ---- delta -----------------------------------------------------------------------

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]: one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             Strides os, Strides dos, int batch, int seq_len, int heads) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * seq_len * heads) return;
  const int h = (int)(row % heads);
  const int t = (int)((row / heads) % seq_len);
  const int b = (int)(row / ((long long)heads * seq_len));
  const T* orow = o + b * os.b + t * os.t + h * os.h;
  const T* drow = dout + b * dos.b + t * dos.t + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += load1(orow + d) * load1(drow + d);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[((long long)b * heads + h) * seq_len + t] = acc;
}

// ---- bf16 route: wgmma + TMA ----------------------------------------------------

constexpr int kSm90Threads = 128;  // one warpgroup, which feeds its own ring
constexpr float kLog2eF = 1.44269504088896340736f;

template <int D>
struct Sm90Cfg {
  static constexpr int kChunk = Bf16Tile<D>::kChunk;
  static constexpr int kRowBytes = Bf16Tile<D>::kRowBytes;
  static constexpr int kBK = 64;                   // keys per tile
  static constexpr int kBQ = 64;                   // queries per tile of the dQ kernel
  static constexpr int kBQKV = D == 128 ? 32 : 64; // queries per tile of the dK/dV kernel
  static constexpr int kStages = 2;                  // ring stages of the dK/dV kernel (Q, dO)
  static constexpr int kDqStages = D == 128 ? 2 : 3;  // of the dQ kernel (K, V): shorter tiles
  static constexpr int kKTile = kBK * D * 2;       // one K or V tile, bytes
  static constexpr int kQTile = kBQ * D * 2;       // one Q or dO tile of the dQ kernel
  static constexpr int kQTileKV = kBQKV * D * 2;   // one Q or dO tile of the dK/dV kernel
  // a dK/dV ring stage: Q, dO, then the tile's lse (log2 units) and delta,
  // padded so that every stage starts on a swizzle boundary
  static constexpr int kDkdvStage = (2 * kQTileKV + 2 * kBQKV * 4 + 1023) / 1024 * 1024;
  static constexpr int kDkdvBars = 2 * kKTile + kStages * kDkdvStage;
  static constexpr int kDkdvSmem = kDkdvBars + 8 * (1 + kStages);
  static constexpr int kDqBars = 2 * kQTile + 2 * kDqStages * kKTile;
  static constexpr int kDqSmem = kDqBars + 8 * (1 + kDqStages);
  // blocks per SM: three warpgroups at 168 registers a thread, two at D 128
  static constexpr int kMinBlocks = D == 128 ? 2 : 3;
  static_assert(kBQKV * kRowBytes % 1024 == 0 && kBK * kRowBytes % 1024 == 0,
                "every box must start on a 1024-byte swizzle boundary");
};

// The value thread x of the warpgroup stores into a dK/dV stage's row
// vectors for the query tile at q0: lse (times log2 e) of query q0 + x
// for x < kRows, delta of query q0 + x - kRows below 2 kRows; zero past T
template <int kRows>
__device__ __forceinline__ float row_value(const float* __restrict__ lse,
                                           const float* __restrict__ delta, long long lrow,
                                           int q0, int seq_len) {
  const int x = threadIdx.x, q = q0 + x % kRows;
  if (x >= 2 * kRows || q >= seq_len) return 0.f;
  return x < kRows ? __ldg(lse + lrow + q) * kLog2eF : __ldg(delta + lrow + q);
}

// Stores it and arrives on the stage's barrier, once per warp
template <int kRows>
__device__ __forceinline__ void store_row_value(float* rows, float value, uint64_t* bar) {
  if (threadIdx.x < 2 * kRows) rows[threadIdx.x] = value;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// dK and dV of one 64-key tile of one (b, h). Thread (warp w,
// lane 4g + t) owns keys 16w + g and 16w + g + 8 of the tile; its S^T
// and dP^T accumulators hold queries 8j + 2t and 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, Sm90Cfg<D>::kMinBlocks)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int n_bh, int seq_len, int heads, float scale,
                  int causal) {
  using C = Sm90Cfg<D>;
  constexpr int BK = C::kBK, BQ = C::kBQKV, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char tiles[];  // TMA boxes, then barriers
  unsigned char* smem = tiles;
  unsigned char* k_s = smem;                    // K, then V: resident
  unsigned char* v_s = smem + C::kKTile;
  unsigned char* ring = smem + 2 * C::kKTile;   // stage s: Q, dO, lse, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kDkdvBars);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bh, kt;  // low key tiles walk the most causal query tiles
  if (!block_work(n_bh, (seq_len + BK - 1) / BK, bh, kt)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int k0 = kt * BK;
  const int qt0 = causal ? k0 / BQ : 0;  // earlier query tiles see none of these keys
  const int n_tiles = (seq_len + BQ - 1) / BQ - qt0;
  const long long lrow = (long long)bh * seq_len;
  init_barriers<kStages, 1 + 4>(smem, bars);
  auto stage = [&](int i) { return ring + (i % kStages) * C::kDkdvStage; };
  auto rows_of = [&](int i) { return reinterpret_cast<float*>(stage(i) + 2 * C::kQTileKV); };
  // the ring's first tiles; each later one is loaded when its stage is
  // freed at the end of the loop body
  if (threadIdx.x == 0) {
    load_pair<D, BK>(&k_map, &v_map, k_s, bars, b, h, k0);
    for (int i = 0; i < kStages && i < n_tiles; ++i)
      load_pair<D, BQ>(&q_map, &do_map, stage(i), bars + 1 + i % kStages, b, h, (qt0 + i) * BQ);
  }
  for (int i = 0; i < kStages && i < n_tiles; ++i)
    store_row_value<BQ>(rows_of(i), row_value<BQ>(lse, delta, lrow, (qt0 + i) * BQ, seq_len),
                        bars + 1 + i % kStages);

  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = scale * kLog2eF;
  float acc_dk[D / 2], acc_dv[D / 2], st[BQ / 2], dpt[BQ / 2];
  zero(acc_dk);
  zero(acc_dv);
  zero(st);
  zero(dpt);
  mbar_wait(bars, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int q0 = (qt0 + i) * BQ;
    unsigned char* q_s = stage(i);
    const unsigned char* do_s = q_s + C::kQTileKV;
    // the tile's lse (log2 units) and delta, by query
    const float* lq = rows_of(i);
    const float* dl = lq + BQ;
    const bool refill = i + kStages < n_tiles;  // the stage's next tile
    const float next_row =
        refill ? row_value<BQ>(lse, delta, lrow, (qt0 + i + kStages) * BQ, seq_len) : 0.f;
    mbar_wait(bars + 1 + s, (i / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, keys as rows, in two groups: P^T
    // forms while dP^T is still in the tensor cores
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(st, kmajor_desc<D, BK>(k_s, ks), kmajor_desc<D, BQ>(q_s, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(dpt, kmajor_desc<D, BK>(v_s, ks), kmajor_desc<D, BQ>(do_s, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T in place of S^T; element 4j + e is key key0 + 8(e >> 1), query
    // q0 + 8j + 2t + (e & 1)
    const bool edge = (causal && q0 < k0 + BK - 1) || q0 + BQ > seq_len;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(st[4 * j + e] * scale_log2 - lq[8 * j + 2 * t + (e & 1)]);
        if (edge) {
          const int q = q0 + 8 * j + 2 * t + (e & 1), key = key0 + 8 * (e >> 1);
          if (q >= seq_len || (causal && key > q)) p = 0.f;
        }
        st[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dpt);

    // per k-step of 16 queries: dS^T (without the scale, which dK takes
    // once at the end), the bf16 hi/lo A operands of P^T and dS^T, then
    // dV += P^T dO and dK += dS^T Q with B MN-major; the next k-step's
    // operands form while this one's products run
    uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4], ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dpt[8 * kk + e] =
            st[8 * kk + e] * (dpt[8 * kk + e] - dl[16 * kk + (e >> 2) * 8 + 2 * t + (e & 1)]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1], p_hi[kk][r], p_lo[kk][r]);
        split_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1], ds_hi[kk][r], ds_lo[kk][r]);
      }
      wgmma_fence();
      const uint64_t do_d = mnmajor_desc<D, BQ>(do_s, kk), q_d = mnmajor_desc<D, BQ>(q_s, kk);
      wgmma_rs<1>(acc_dv, p_lo[kk], do_d);
      wgmma_rs<1>(acc_dv, p_hi[kk], do_d);
      wgmma_rs<1>(acc_dk, ds_lo[kk], q_d);
      wgmma_rs<1>(acc_dk, ds_hi[kk], q_d);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    if (refill) {
      __syncthreads();  // every warp is done with stage s
      if (threadIdx.x == 0)
        load_pair<D, BQ>(&q_map, &do_map, q_s, bars + 1 + s, b, h, (qt0 + i + kStages) * BQ);
      store_row_value<BQ>(rows_of(i), next_row, bars + 1 + s);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= seq_len) continue;
    const long long row = (((long long)b * seq_len + key) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      store2(dk + row + col, acc_dk[4 * j + 2 * r] * scale, acc_dk[4 * j + 2 * r + 1] * scale);
      store2(dv + row + col, acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
}

// dQ of one 64-query tile of one (b, h). Thread (warp w, lane
// 4g + t) owns queries 16w + g and 16w + g + 8 of the tile; its S and dP
// accumulators hold keys 8j + 2t and 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, Sm90Cfg<D>::kMinBlocks)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int n_bh,
                int seq_len, int heads, float scale, int causal) {
  using C = Sm90Cfg<D>;
  constexpr int BK = C::kBK, BQ = C::kBQ, kStages = C::kDqStages;
  extern __shared__ __align__(1024) unsigned char tiles[];  // TMA boxes, then barriers
  unsigned char* smem = tiles;
  unsigned char* q_s = smem;                    // Q, then dO: resident
  unsigned char* do_s = smem + C::kQTile;
  unsigned char* ring = smem + 2 * C::kQTile;   // stage s: K at 2s, V at 2s+1
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kDqBars);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bh, rank;  // high query tiles walk the most key tiles
  const int n_qt = (seq_len + BQ - 1) / BQ;
  if (!block_work(n_bh, n_qt, bh, rank)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (n_qt - 1 - rank) * BQ;
  int n_tiles = (seq_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);  // later tiles fully masked
  init_barriers<kStages, 1>(smem, bars);
  auto stage = [&](int i) { return ring + (i % kStages) * 2 * C::kKTile; };
  // the ring's first tiles; each later one is loaded when its stage is
  // freed at the end of the loop body
  if (threadIdx.x == 0) {
    load_pair<D, BQ>(&q_map, &do_map, q_s, bars, b, h, q0);
    for (int i = 0; i < kStages && i < n_tiles; ++i)
      load_pair<D, BK>(&k_map, &v_map, stage(i), bars + 1 + i % kStages, b, h, i * BK);
  }

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's queries: row0, row0 + 8
  const float scale_log2 = scale * kLog2eF;
  const long long lrow = (long long)bh * seq_len;
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    lq[r] = q < seq_len ? lse[lrow + q] * kLog2eF : 0.f;
    dl[r] = q < seq_len ? delta[lrow + q] : 0.f;
  }
  float acc_dq[D / 2], sc[BK / 2], dp[BK / 2];
  zero(acc_dq);
  zero(sc);
  zero(dp);
  mbar_wait(bars, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = i * BK;
    unsigned char* k_s = stage(i);
    const unsigned char* v_s = k_s + C::kKTile;
    mbar_wait(bars + 1 + s, (i / kStages) & 1);

    // S = Q K^T and dP = dO V^T in two groups: P forms while dP is
    // still in the tensor cores
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(sc, kmajor_desc<D, BQ>(q_s, ks), kmajor_desc<D, BK>(k_s, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(dp, kmajor_desc<D, BQ>(do_s, ks), kmajor_desc<D, BK>(v_s, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P in place of S; element 4j + e is query row0 + 8(e >> 1), key k0 +
    // 8j + 2t + (e & 1)
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > seq_len;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(sc[4 * j + e] * scale_log2 - lq[e >> 1]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), q = row0 + 8 * (e >> 1);
          if (key >= seq_len || (causal && key > q)) p = 0.f;
        }
        sc[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);

    // per k-step of 16 keys: dS (without the scale, which dQ takes once at
    // the end), its bf16 hi/lo A operands, then dQ += dS K with B (K)
    // MN-major; the next k-step's operands form while this one's products
    // run
    uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dp[8 * kk + e] = sc[8 * kk + e] * (dp[8 * kk + e] - dl[(e >> 1) & 1]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], ds_hi[kk][r], ds_lo[kk][r]);
      wgmma_fence();
      const uint64_t k_d = mnmajor_desc<D, BK>(k_s, kk);
      wgmma_rs<1>(acc_dq, ds_lo[kk], k_d);
      wgmma_rs<1>(acc_dq, ds_hi[kk], k_d);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    if (i + kStages < n_tiles) {
      __syncthreads();  // every warp is done with stage s
      if (threadIdx.x == 0)
        load_pair<D, BK>(&k_map, &v_map, k_s, bars + 1 + s, b, h, (i + kStages) * BK);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= seq_len) continue;
    __nv_bfloat16* out = dq + (((long long)b * seq_len + q) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(out + 8 * j + 2 * t, acc_dq[4 * j + 2 * r] * scale, acc_dq[4 * j + 2 * r + 1] * scale);
  }
}

// ---- f32 route: TF32 wgmma + TMA ------------------------------------------------

// A [kRows, kCols] f32 tile as TMA stores it (and as the staging pass
// writes its copies): boxes of kChunk columns (rows of at most 128
// bytes), each swizzled by its row bytes
template <int kCols>
struct F32Tile {
  static constexpr int kChunk = kCols > 32 ? 32 : kCols;
  static constexpr int kRowBytes = kChunk * 4;
};

template <int kRows, int kCols>
__device__ __forceinline__ int f32_off(int row, int col) {
  return tile_off<float, F32Tile<kCols>::kChunk, kRows>(row, col);
}

// Descriptor of k-step `ks` (columns 8ks .. 8ks + 7) of a [kRows, kCols]
// f32 tile read K-major (the reduction runs along the row)
template <int kRows, int kCols>
__device__ __forceinline__ uint64_t tf32_desc(const unsigned char* tile, int ks) {
  using C = F32Tile<kCols>;
  return smem_desc(tile + (ks * 8 / C::kChunk) * kRows * C::kRowBytes + (ks * 8 % C::kChunk) * 4,
                   C::kRowBytes, 16, 8 * C::kRowBytes);
}

// Thread 0: rows `row` .. `row` + kRows - 1 of (b, h) of a [B, T, H, D]
// f32 map into `dst` by TMA on `bar`, whose expected bytes the caller sets
template <int D, int kRows>
__device__ __forceinline__ void tma_f32(const CUtensorMap* map, unsigned char* dst, uint64_t* bar,
                                        int b, int h, int row) {
  using C = F32Tile<D>;
#pragma unroll
  for (int c = 0; c < D / C::kChunk; ++c)
    tma_load(dst + c * kRows * C::kRowBytes, map, bar, c * C::kChunk, h, row, b);
}

// The column of a transposed copy that row r of a streamed tile goes to:
// within each 8, rows 2t and 2t + 1 go to columns t and t + 4, the k
// order in which wgmma reads an accumulator fed back as its A operand
// (accumulator columns 2t, 2t + 1 as A's k t, t + 4)
__device__ __forceinline__ int kpos(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// The staging pass over a [kRows, D] f32 tile that TMA wrote at `hi`, by
// kThreadsN threads (`tid` this one's index among them): each x becomes
// hi = tf32(x) in place and lo = tf32(x - hi) at `lo` (the same layout).
// A warp's lanes take consecutive rows of one 4-column unit, so its
// 16-byte loads and stores touch every bank once; the loop is unrolled
// whole, so that all of a thread's loads are in flight at once (two warps
// a scheduler hide little latency).
template <int D, int kRows, int kThreadsN>
__device__ __forceinline__ void stage_tile(unsigned char* hi, unsigned char* lo, int tid) {
  constexpr int kUnits = kRows * D / 4;
#pragma unroll
  for (int u = tid; u < kUnits; u += kThreadsN) {
    const int off = f32_off<kRows, D>(u % kRows, u / kRows * 4);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The transposing pass, after stage_tile, by the same threads: hi and lo
// of the [kRows, D] tile copied to the [D, kRows] tiles `thi` and `tlo`,
// rows placed by kpos. It only reads the staged tile, so it runs while
// the products that read that tile are in flight. Lanes on consecutive
// rows make the transposed 4-byte stores touch every bank once at kRows
// >= 32.
template <int D, int kRows, int kThreadsN>
__device__ __forceinline__ void transpose_tile(const unsigned char* hi, const unsigned char* lo,
                                               unsigned char* thi, unsigned char* tlo, int tid) {
  constexpr int kUnits = kRows * D / 4;
#pragma unroll
  for (int u = tid; u < kUnits; u += kThreadsN) {
    const int r = u % kRows, c = u / kRows * 4, p = kpos(r);
    const int off = f32_off<kRows, D>(r, c);
    const uint4 h = *reinterpret_cast<const uint4*>(hi + off);
    const uint4 l = *reinterpret_cast<const uint4*>(lo + off);
    const uint32_t hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = f32_off<D, kRows>(c + j, p);
      *reinterpret_cast<uint32_t*>(thi + t) = hs[j];
      *reinterpret_cast<uint32_t*>(tlo + t) = ls[j];
    }
  }
}

// A resident [64, D] hi tile's TF32 A operands in registers, one k-step
// of 8 columns each, in wgmma_tf32_rs's order: (16w + g, 8ks + t), (16w
// + g + 8, 8ks + t), (16w + g, 8ks + t + 4), (16w + g + 8, 8ks + t + 4)
template <int D, int KS>
__device__ __forceinline__ void load_a(const unsigned char* tile, int warp, int lane,
                                       uint32_t (&a)[KS][4]) {
  const int r = warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[ks][i] = *reinterpret_cast<const uint32_t*>(
          tile + f32_off<64, D>(r + 8 * (i & 1), 8 * ks + t + 4 * (i >> 1)));
}

// d = A B^T over D, 3xTF32: per k-step of 8 columns lo hi, hi lo, hi hi
// into one accumulator (the first overwrites it). A is a resident [64, D]
// tile (`a_hi`, `a_lo`), B a [kN, D] stage tile (`b_hi`, `b_lo`), both read
// K-major. With kRegA, A's hi comes from the registers `ahi` (load_a): its
// two passes read only B from shared memory, where the same pass from a
// descriptor would read A's 2 KB again each time.
template <int D, int kN, bool kRegA, int N, int KS>
__device__ __forceinline__ void scores_3x(float (&d)[N], const unsigned char* a_hi,
                                          const unsigned char* a_lo, const uint32_t (&ahi)[KS][4],
                                          const unsigned char* b_hi, const unsigned char* b_lo) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const uint64_t bh = tf32_desc<kN, D>(b_hi, ks);
    wgmma_tf32_ss(d, tf32_desc<64, D>(a_lo, ks), bh, ks > 0);
    if constexpr (kRegA) {
      wgmma_tf32_rs(d, ahi[ks], tf32_desc<kN, D>(b_lo, ks));
      wgmma_tf32_rs(d, ahi[ks], bh);
    } else {
      const uint64_t ah = tf32_desc<64, D>(a_hi, ks);
      wgmma_tf32_ss(d, ah, tf32_desc<kN, D>(b_lo, ks), 1);
      wgmma_tf32_ss(d, ah, bh, 1);
    }
  }
}

// An accumulator of 8 columns (elements 4kk .. 4kk + 3) as a TF32 A
// operand, hi and lo: A's (row, k) order (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) takes elements 0, 2, 1, 3 (columns 2t and 2t + 1 as k t
// and t + 4, which kpos matches on the B side)
template <int N>
__device__ __forceinline__ void a_operand(const float (&acc)[N], int kk, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split(acc[4 * kk], hi[0], lo[0]);
  split(acc[4 * kk + 2], hi[1], lo[1]);
  split(acc[4 * kk + 1], hi[2], lo[2]);
  split(acc[4 * kk + 3], hi[3], lo[3]);
}

constexpr int kF32Threads = 2 * kSm90Threads;  // two consumer warpgroups a block

// Named barrier of warpgroup `wg` alone (id 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kSm90Threads) : "memory");
}

// The two warpgroups' partial sums `a`, added in one order: warpgroup 1
// stores its own to `buf` (free shared memory of 128 x N floats), and
// warpgroup 0 adds them to its own. Every thread of the block calls this.
template <int N>
__device__ __forceinline__ void combine_partials(float (&a)[N], unsigned char* buf, int wg,
                                                 int tid) {
  float* p = reinterpret_cast<float*>(buf);
  __syncthreads();  // both warpgroups are done with their stages (and buf)
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e * kSm90Threads + tid] = a[e];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) a[e] += p[e * kSm90Threads + tid];
  }
}

template <int D>
struct F32Cfg {
  static constexpr int kBK = 64;                                 // keys per dK/dV block
  static constexpr int kBQ = 64;                                 // queries per dQ block
  static constexpr int kQS = D <= 32 ? 64 : D == 64 ? 32 : 8;    // queries a dK/dV step
  static constexpr int kKS = D <= 32 ? 64 : D == 64 ? 32 : 16;   // keys a dQ step
  // the resident tiles' hi A operands held in registers (scores_3x), where
  // the registers allow: K's and V's in the dK/dV kernel, Q's and dO's in
  // the dQ kernel (D / 2 registers each)
  static constexpr bool kDkdvRegA = D == 16 || D == 64;
  static constexpr bool kDqRegA = D <= 64;
  static constexpr int kTile = 64 * D * 4;                       // a resident [64, D] tile
  static constexpr int kQTile = kQS * D * 4;                     // a streamed tile, dK/dV
  static constexpr int kKTile = kKS * D * 4;                     // a streamed tile, dQ
  // a dK/dV stage: Q hi, Q lo, Q^T hi, Q^T lo, the same four of dO, then
  // the step's lse (log2 units) and delta; a dQ stage: K hi, K lo, K^T
  // hi, K^T lo, V hi, V lo. One stage for each of the two warpgroups.
  static constexpr int kDkdvStage = (8 * kQTile + 2 * kQS * 4 + 1023) / 1024 * 1024;
  static constexpr int kDkdvBars = 4 * kTile + 2 * kDkdvStage;
  static constexpr int kDkdvSmem = kDkdvBars + 8 * 3;
  static constexpr int kDqStage = 6 * kKTile;
  static constexpr int kDqBars = 4 * kTile + 2 * kDqStage;
  static constexpr int kDqSmem = kDqBars + 8 * 3;
  static_assert(kQTile % 1024 == 0 && kKTile % 1024 == 0,
                "every tile must start on a 1024-byte swizzle boundary");
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "227 KB of shared memory a block");
  // warpgroup 1's partial sums fit where the stages were
  static_assert(2 * kDkdvStage >= 64 * D * 4 && 2 * kDqStage >= 64 * D * 4,
                "room for a warpgroup's partial dK, dV or dQ");
};

// dK and dV of one 64-key tile of one (b, h), 3xTF32, by two warpgroups
// that share the resident K and V and take the query steps in turn
// (warpgroup w the steps i = w, w + 2, ...), each with its own stage and
// partial dK and dV, added in one fixed order at the end. While one
// warpgroup runs its staging pass or its softmax, the other's products
// hold the tensor cores. Thread (warp w, lane 4g + t) of a warpgroup owns
// keys 16(w % 4) + g and 16(w % 4) + g + 8 of the tile; its S^T and dP^T
// accumulators hold queries 8j + 2t and 8j + 2t + 1 of the step.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
dkdv_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                 int n_bh, int seq_len, int heads, float scale, int causal) {
  using C = F32Cfg<D>;
  constexpr int BK = C::kBK, BQ = C::kQS, QT = C::kQTile;
  extern __shared__ __align__(1024) unsigned char tiles[];  // tiles, then barriers
  unsigned char* smem = tiles;
  unsigned char* k_hi = smem;  // K hi, K lo, V hi, V lo: resident
  unsigned char* k_lo = smem + C::kTile;
  unsigned char* v_hi = smem + 2 * C::kTile;
  unsigned char* v_lo = smem + 3 * C::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kDkdvBars);

  const int wg = threadIdx.x / kSm90Threads, tid = threadIdx.x % kSm90Threads;
  const int warp = tid >> 5, lane = tid & 31;
  // this warpgroup's stage: Q hi, Q lo, Q^T hi, Q^T lo, the same four of
  // dO, then the step's lse (log2 units) and delta
  unsigned char* const st0 = smem + 4 * C::kTile + wg * C::kDkdvStage;
  uint64_t* const bar = bars + 1 + wg;
  int bh, kt;  // low key tiles walk the most causal query tiles
  if (!block_work(n_bh, (seq_len + BK - 1) / BK, bh, kt)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int k0 = kt * BK;
  const int qt0 = causal ? k0 / BQ : 0;  // earlier query steps see none of these keys
  const int n_tiles = (seq_len + BQ - 1) / BQ - qt0;
  const long long lrow = (long long)bh * seq_len;
  init_barriers<2, 1>(smem, bars);
  // the warpgroup's thread 0: step i's Q and dO into its stage's hi slots
  auto load_q = [&](int i) {
    mbar_expect_tx(bar, 2 * QT);
    tma_f32<D, BQ>(&q_map, st0, bar, b, h, (qt0 + i) * BQ);
    tma_f32<D, BQ>(&do_map, st0 + 4 * QT, bar, b, h, (qt0 + i) * BQ);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars, 2 * C::kTile);
    tma_f32<D, BK>(&k_map, k_hi, bars, b, h, k0);
    tma_f32<D, BK>(&v_map, v_hi, bars, b, h, k0);
  }
  if (tid == 0 && wg < n_tiles) load_q(wg);
  mbar_wait(bars, 0);
  stage_tile<D, BK, kF32Threads>(k_hi, k_lo, threadIdx.x);
  stage_tile<D, BK, kF32Threads>(v_hi, v_lo, threadIdx.x);
  fence_proxy_async();
  __syncthreads();
  uint32_t ka[C::kDkdvRegA ? D / 8 : 1][4], va[C::kDkdvRegA ? D / 8 : 1][4];
  if constexpr (C::kDkdvRegA) {
    load_a<D>(k_hi, warp, lane, ka);
    load_a<D>(v_hi, warp, lane, va);
  }

  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = scale * kLog2eF;
  const unsigned char* q_hi = st0;
  const unsigned char* q_lo = st0 + QT;
  const unsigned char* qt_hi = st0 + 2 * QT;
  const unsigned char* qt_lo = st0 + 3 * QT;
  const unsigned char* do_hi = st0 + 4 * QT;
  const unsigned char* do_lo = st0 + 5 * QT;
  const unsigned char* dot_hi = st0 + 6 * QT;
  const unsigned char* dot_lo = st0 + 7 * QT;
  float* const rows = reinterpret_cast<float*>(st0 + 8 * QT);  // lse (log2 units), delta
  float acc_dk[D / 2], acc_dv[D / 2], st[BQ / 2], dpt[BQ / 2];
  zero(acc_dk);
  zero(acc_dv);
  zero(st);
  zero(dpt);

  // the lse (log2 units) or delta this thread stores for step j
  auto row_value = [&](int j) {
    const int q = (qt0 + j) * BQ + tid % BQ;
    if (tid >= 2 * BQ || q >= seq_len) return 0.f;
    return tid < BQ ? __ldg(lse + lrow + q) * kLog2eF : __ldg(delta + lrow + q);
  };
  float next_row = row_value(wg);

  for (int i = wg, use = 0; i < n_tiles; i += 2, ++use) {
    const int q0 = (qt0 + i) * BQ;
    // the step's staging pass once its tiles have landed, and its lse and
    // delta (loaded a step ahead)
    mbar_wait(bar, use & 1);
    stage_tile<D, BQ, kSm90Threads>(st0, st0 + QT, tid);
    stage_tile<D, BQ, kSm90Threads>(st0 + 4 * QT, st0 + 5 * QT, tid);
    if (tid < 2 * BQ) rows[tid] = next_row;
    fence_proxy_async();
    wg_sync(wg);

    // S^T = K Q^T and dP^T = V dO^T, keys as rows, three passes each (lo
    // hi, hi lo, hi hi) in two groups: P^T forms while dP^T computes
    wgmma_fence();
    scores_3x<D, BQ, C::kDkdvRegA>(st, k_hi, k_lo, ka, q_hi, q_lo);
    wgmma_commit();
    scores_3x<D, BQ, C::kDkdvRegA>(dpt, v_hi, v_lo, va, do_hi, do_lo);
    wgmma_commit();
    // the transposed copies of Q and dO while S^T and dP^T compute
    transpose_tile<D, BQ, kSm90Threads>(q_hi, q_lo, st0 + 2 * QT, st0 + 3 * QT, tid);
    transpose_tile<D, BQ, kSm90Threads>(do_hi, do_lo, st0 + 6 * QT, st0 + 7 * QT, tid);
    fence_proxy_async();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T in place of S^T; element 4j + e is key key0 + 8(e >> 1), query
    // q0 + 8j + 2t + (e & 1)
    const bool edge = (causal && q0 < k0 + BK - 1) || q0 + BQ > seq_len;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(st[4 * j + e] * scale_log2 - rows[8 * j + 2 * t + (e & 1)]);
        if (edge) {
          const int q = q0 + 8 * j + 2 * t + (e & 1), key = key0 + 8 * (e >> 1);
          if (q >= seq_len || (causal && key > q)) p = 0.f;
        }
        st[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dpt);

    // dS^T (without the scale, which dK takes once at the end) and the
    // TF32 hi/lo A operands of P^T and dS^T per k-step of 8 queries
    uint32_t p_hi[BQ / 8][4], p_lo[BQ / 8][4], ds_hi[BQ / 8][4], ds_lo[BQ / 8][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * kk + e] =
            st[4 * kk + e] * (dpt[4 * kk + e] - rows[BQ + 8 * kk + 2 * t + (e & 1)]);
      a_operand(st, kk, p_hi[kk], p_lo[kk]);
      a_operand(dpt, kk, ds_hi[kk], ds_lo[kk]);
    }
    // the transposed copies are written and the step's natural Q and dO
    // read: the warpgroup's step after next lands in their slots while dV
    // and dK compute
    wg_sync(wg);
    if (i + 2 < n_tiles) {
      if (tid == 0) load_q(i + 2);
      next_row = row_value(i + 2);
    }

    // dV += P^T dO and dK += dS^T Q, B the transposed copies; the A
    // operands and the accumulators are pinned here, so that the compiler
    // moves none of their writes past the fence
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      const uint64_t oh = tf32_desc<D, BQ>(dot_hi, kk), qh = tf32_desc<D, BQ>(qt_hi, kk);
      wgmma_tf32_rs(acc_dv, p_lo[kk], oh);
      wgmma_tf32_rs(acc_dv, p_hi[kk], tf32_desc<D, BQ>(dot_lo, kk));
      wgmma_tf32_rs(acc_dv, p_hi[kk], oh);
      wgmma_tf32_rs(acc_dk, ds_lo[kk], qh);
      wgmma_tf32_rs(acc_dk, ds_hi[kk], tf32_desc<D, BQ>(qt_lo, kk));
      wgmma_tf32_rs(acc_dk, ds_hi[kk], qh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
  }
  combine_partials(acc_dk, smem + 4 * C::kTile, wg, tid);
  combine_partials(acc_dv, smem + 4 * C::kTile, wg, tid);
  if (wg) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= seq_len) continue;
    const long long row = (((long long)b * seq_len + key) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      store2(dk + row + col, acc_dk[4 * j + 2 * r] * scale, acc_dk[4 * j + 2 * r + 1] * scale);
      store2(dv + row + col, acc_dv[4 * j + 2 * r], acc_dv[4 * j + 2 * r + 1]);
    }
  }
}

// dQ of one 64-query tile of one (b, h), 3xTF32, by two warpgroups that
// share the resident Q and dO and take the key steps in turn, as the
// dK/dV kernel does. Thread (warp w, lane 4g + t) of a warpgroup owns
// queries 16(w % 4) + g and 16(w % 4) + g + 8 of the tile; its S and dP
// accumulators hold keys 8j + 2t and 8j + 2t + 1 of the step.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
dq_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq, int n_bh, int seq_len,
               int heads, float scale, int causal) {
  using C = F32Cfg<D>;
  constexpr int BQ = C::kBQ, BK = C::kKS, KT = C::kKTile;
  extern __shared__ __align__(1024) unsigned char tiles[];  // tiles, then barriers
  unsigned char* smem = tiles;
  unsigned char* q_hi = smem;  // Q hi, Q lo, dO hi, dO lo: resident
  unsigned char* q_lo = smem + C::kTile;
  unsigned char* do_hi = smem + 2 * C::kTile;
  unsigned char* do_lo = smem + 3 * C::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kDqBars);

  const int wg = threadIdx.x / kSm90Threads, tid = threadIdx.x % kSm90Threads;
  const int warp = tid >> 5, lane = tid & 31;
  // this warpgroup's stage: K hi, K lo, K^T hi, K^T lo, V hi, V lo
  unsigned char* const st0 = smem + 4 * C::kTile + wg * C::kDqStage;
  uint64_t* const bar = bars + 1 + wg;
  int bh, rank;  // high query tiles walk the most key tiles
  const int n_qt = (seq_len + BQ - 1) / BQ;
  if (!block_work(n_bh, n_qt, bh, rank)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (n_qt - 1 - rank) * BQ;
  int n_tiles = (seq_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);  // later steps fully masked
  init_barriers<2, 1>(smem, bars);
  // the warpgroup's thread 0: step i's K and V into its stage's hi slots
  auto load_kv = [&](int i) {
    mbar_expect_tx(bar, 2 * KT);
    tma_f32<D, BK>(&k_map, st0, bar, b, h, i * BK);
    tma_f32<D, BK>(&v_map, st0 + 4 * KT, bar, b, h, i * BK);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars, 2 * C::kTile);
    tma_f32<D, BQ>(&q_map, q_hi, bars, b, h, q0);
    tma_f32<D, BQ>(&do_map, do_hi, bars, b, h, q0);
  }
  if (tid == 0 && wg < n_tiles) load_kv(wg);

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's queries: row0, row0 + 8
  const float scale_log2 = scale * kLog2eF;
  const long long lrow = (long long)bh * seq_len;
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    lq[r] = q < seq_len ? lse[lrow + q] * kLog2eF : 0.f;
    dl[r] = q < seq_len ? delta[lrow + q] : 0.f;
  }
  mbar_wait(bars, 0);
  stage_tile<D, BQ, kF32Threads>(q_hi, q_lo, threadIdx.x);
  stage_tile<D, BQ, kF32Threads>(do_hi, do_lo, threadIdx.x);
  fence_proxy_async();
  __syncthreads();
  uint32_t qa[C::kDqRegA ? D / 8 : 1][4], oa[C::kDqRegA ? D / 8 : 1][4];
  if constexpr (C::kDqRegA) {
    load_a<D>(q_hi, warp, lane, qa);
    load_a<D>(do_hi, warp, lane, oa);
  }

  const unsigned char* k_hi = st0;
  const unsigned char* k_lo = st0 + KT;
  const unsigned char* kt_hi = st0 + 2 * KT;
  const unsigned char* kt_lo = st0 + 3 * KT;
  const unsigned char* v_hi = st0 + 4 * KT;
  const unsigned char* v_lo = st0 + 5 * KT;
  float acc_dq[D / 2], sc[BK / 2], dp[BK / 2];
  zero(acc_dq);
  zero(sc);
  zero(dp);

  for (int i = wg, use = 0; i < n_tiles; i += 2, ++use) {
    const int k0 = i * BK;
    mbar_wait(bar, use & 1);
    stage_tile<D, BK, kSm90Threads>(st0, st0 + KT, tid);
    stage_tile<D, BK, kSm90Threads>(st0 + 4 * KT, st0 + 5 * KT, tid);
    fence_proxy_async();
    wg_sync(wg);

    // S = Q K^T and dP = dO V^T, three passes each, in two groups: P
    // forms while dP computes
    wgmma_fence();
    scores_3x<D, BK, C::kDqRegA>(sc, q_hi, q_lo, qa, k_hi, k_lo);
    wgmma_commit();
    scores_3x<D, BK, C::kDqRegA>(dp, do_hi, do_lo, oa, v_hi, v_lo);
    wgmma_commit();
    // the transposed copy of K while S and dP compute
    transpose_tile<D, BK, kSm90Threads>(k_hi, k_lo, st0 + 2 * KT, st0 + 3 * KT, tid);
    fence_proxy_async();
    wgmma_wait<1>();
    fence_regs(sc);

    // P in place of S; element 4j + e is query row0 + 8(e >> 1), key k0 +
    // 8j + 2t + (e & 1)
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > seq_len;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(sc[4 * j + e] * scale_log2 - lq[e >> 1]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), q = row0 + 8 * (e >> 1);
          if (key >= seq_len || (causal && key > q)) p = 0.f;
        }
        sc[4 * j + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS (without the scale, which dQ takes once at the end) and its TF32
    // hi/lo A operands per k-step of 8 keys
    uint32_t ds_hi[BK / 8][4], ds_lo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * kk + e] = sc[4 * kk + e] * (dp[4 * kk + e] - dl[e >> 1]);
      a_operand(dp, kk, ds_hi[kk], ds_lo[kk]);
    }
    // the transposed copy is written and the step's natural K and V
    // read: the warpgroup's step after next lands in their slots while dQ
    // computes
    wg_sync(wg);
    if (tid == 0 && i + 2 < n_tiles) load_kv(i + 2);

    // dQ += dS K, B the transposed copy of K; the A operands and the
    // accumulator are pinned here, as in the dK/dV kernel
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    fence_regs(acc_dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t kh = tf32_desc<D, BK>(kt_hi, kk);
      wgmma_tf32_rs(acc_dq, ds_lo[kk], kh);
      wgmma_tf32_rs(acc_dq, ds_hi[kk], tf32_desc<D, BK>(kt_lo, kk));
      wgmma_tf32_rs(acc_dq, ds_hi[kk], kh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
  }
  combine_partials(acc_dq, smem + 4 * C::kTile, wg, tid);
  if (wg) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= seq_len) continue;
    float* out = dq + (((long long)b * seq_len + q) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(out + 8 * j + 2 * t, acc_dq[4 * j + 2 * r] * scale, acc_dq[4 * j + 2 * r + 1] * scale);
  }
}

// ---- host side ------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  int batch, seq_len, heads;
  Strides qs, ks, vs, os, dos;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
void launch_delta(const Args& a) {
  const long long rows = (long long)a.batch * a.seq_len * a.heads;
  delta_kernel<T, D><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), static_cast<float*>(a.delta),
      a.os, a.dos, a.batch, a.seq_len, a.heads);
}

template <int D>
int launch_f32(const Args& a) {
  using C = F32Cfg<D>;
  // maps with the box of each tile: Q and dO of 64 queries (dQ kernel)
  // and of kQS (dK/dV kernel), K and V of 64 keys (dK/dV) and of kKS (dQ)
  CUtensorMap q_map, do_map, k_map, v_map, q_kv_map, do_kv_map, k_q_map, v_q_map;
  const int B = a.batch, T = a.seq_len, H = a.heads, chunk = F32Tile<D>::kChunk;
  int rc = encode<float>(&q_map, a.q, B, T, H, D, a.qs, chunk, C::kBQ);
  if (rc == 0) rc = encode<float>(&do_map, a.dout, B, T, H, D, a.dos, chunk, C::kBQ);
  if (rc == 0) rc = encode<float>(&k_map, a.k, B, T, H, D, a.ks, chunk, C::kBK);
  if (rc == 0) rc = encode<float>(&v_map, a.v, B, T, H, D, a.vs, chunk, C::kBK);
  if (rc == 0) rc = encode<float>(&q_kv_map, a.q, B, T, H, D, a.qs, chunk, C::kQS);
  if (rc == 0) rc = encode<float>(&do_kv_map, a.dout, B, T, H, D, a.dos, chunk, C::kQS);
  if (rc == 0) rc = encode<float>(&k_q_map, a.k, B, T, H, D, a.ks, chunk, C::kKS);
  if (rc == 0) rc = encode<float>(&v_q_map, a.v, B, T, H, D, a.vs, chunk, C::kKS);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(dkdv_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kDkdvSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  launch_delta<float, D>(a);
  dkdv_tf32_kernel<D><<<work_grid(B * H, (T + C::kBK - 1) / C::kBK), kF32Threads,
                        C::kDkdvSmem, a.stream>>>(q_kv_map, k_map, v_map, do_kv_map, lse, delta,
                                                  static_cast<float*>(a.dk),
                                                  static_cast<float*>(a.dv), B * H, T, H,
                                    a.scale, a.causal);
  dq_tf32_kernel<D><<<work_grid(B * H, (T + C::kBQ - 1) / C::kBQ), kF32Threads, C::kDqSmem,
                      a.stream>>>(q_map, k_q_map, v_q_map, do_map, lse, delta,
                                  static_cast<float*>(a.dq), B * H, T, H, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a) {
  using C = Sm90Cfg<D>;
  using bf16 = __nv_bfloat16;
  // maps with the box of each tile: K and V of 64 keys, Q and dO of 64
  // queries (dQ kernel) and of kBQKV (dK/dV kernel)
  CUtensorMap k_map, v_map, q_map, do_map, q_kv_map, do_kv_map;
  const int B = a.batch, T = a.seq_len, H = a.heads;
  int rc = encode<bf16>(&k_map, a.k, B, T, H, D, a.ks, C::kChunk, C::kBK);
  if (rc == 0) rc = encode<bf16>(&v_map, a.v, B, T, H, D, a.vs, C::kChunk, C::kBK);
  if (rc == 0) rc = encode<bf16>(&q_map, a.q, B, T, H, D, a.qs, C::kChunk, C::kBQ);
  if (rc == 0) rc = encode<bf16>(&do_map, a.dout, B, T, H, D, a.dos, C::kChunk, C::kBQ);
  if (rc == 0) rc = encode<bf16>(&q_kv_map, a.q, B, T, H, D, a.qs, C::kChunk, C::kBQKV);
  if (rc == 0) rc = encode<bf16>(&do_kv_map, a.dout, B, T, H, D, a.dos, C::kChunk, C::kBQKV);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(dkdv_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kDkdvSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  launch_delta<bf16, D>(a);
  dkdv_wgmma_kernel<D><<<work_grid(B * H, (T + C::kBK - 1) / C::kBK), kSm90Threads,
                         C::kDkdvSmem, a.stream>>>(q_kv_map, k_map, v_map, do_kv_map, lse, delta,
                                                   static_cast<bf16*>(a.dk),
                                                   static_cast<bf16*>(a.dv), B * H, T, H,
                                     a.scale, a.causal);
  dq_wgmma_kernel<D><<<work_grid(B * H, (T + C::kBQ - 1) / C::kBQ), kSm90Threads,
                       C::kDqSmem, a.stream>>>(q_map, k_map, v_map, do_map, lse, delta,
                                               static_cast<bf16*>(a.dq), B * H, T, H, a.scale,
                                               a.causal);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype == 0) {
    switch (head_dim) {
      case 16: return launch_f32<16>(a);
      case 32: return launch_f32<32>(a);
      case 64: return launch_f32<64>(a);
      case 128: return launch_f32<128>(a);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 16: return launch_bf16<16>(a);
      case 32: return launch_bf16<32>(a);
      case 64: return launch_bf16<64>(a);
      case 128: return launch_bf16<128>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o and dout are [B, T, H, D]
// views (unit-stride D) whose base and strides of dimensions longer than 1
// are 16-byte multiples; lse and delta are contiguous f32 [B, H, T] (delta
// is scratch, written here); dq, dk, dv are contiguous [B, T, H, D] in the
// input dtype. Returns 0 on success, else the CUDA error code of the
// launches or a tensor-map code of hopper.cuh; the caller raises on
// anything but 0.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* lse, const void* dout, void* dq, void* dk, void* dv,
                        void* delta, int dtype, int batch, int seq_len, int heads,
                        int head_dim, long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh, long long v_sb,
                        long long v_st, long long v_sh, long long o_sb, long long o_st,
                        long long o_sh, long long do_sb, long long do_st, long long do_sh,
                        float scale, int causal, void* stream) {
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, delta, batch, seq_len, heads,
               Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh},
               Strides{o_sb, o_st, o_sh}, Strides{do_sb, do_st, do_sh}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a);
}

const char* flash_attention_bwd_error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
