// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (fedml_tpu/ops/flash_attention.py:32, launched by `_flash_forward` at
// :68 through pl.pallas_call at :83). Same function: scaled-dot-product
// attention over [B, T, H, D] inputs (D in {16, 32, 64, 128}, any T, any
// B*H) with an online softmax carried in f32 across key tiles, causal
// masking with -1e30, fully masked key tiles skipped, and two outputs: O
// [B, T, H, D] in the input dtype, contiguous, and the per-row log-sum-exp
// lse = m + log(max(l, 1e-30)) as f32 [B, H, T]. Scores are kept in log2
// units (scale * log2(e) folded into one multiply), so each weight is one
// ex2. No atomics: two runs agree bitwise.
//
// Bound on an H100: causal attention at the paths' shapes (T 4096, D 64)
// does ~2*T*D flops per byte it must move, far above the card's balance
// point, so operations bound it. Two routes, one per input dtype; the
// grid puts batch*head on x (up to 2^31 - 1) and the 64-row query tile on
// y (tiles past y's 65,535 fold into x: `work_grid`), and `block_work`
// (hopper.cuh) hands blocks out 16 heads at a time, longest causal walk
// first, so the blocks in flight stream K and V of a
// few heads, which stay in L2.
//
// bf16 route (the training path): `flash_fwd_wgmma_kernel`. One
// warpgroup per block owns 64 query rows, three blocks an SM (two at D
// 128); no producer warp (five warps would count as six for the register
// allocator): thread 0 loads Q once and K/V tiles of 64 keys by TMA (4-D
// tensor maps over the [B, T, H, D] strides, 128/64/32-byte swizzle)
// through an mbarrier ring of four stages (three at D 128), refilling a
// stage as soon as the warpgroup is done with it. Q, K and V stay bf16 in
// shared memory, in the layout TMA writes and `wgmma` reads by descriptor.
// - S = Q K^T is one bf16 `wgmma` pass (bf16 products are exact, f32
//   accumulation). Rows and keys past T arrive as TMA's zero fill and are
//   masked.
// - O += P V takes P from registers: S's accumulator layout is `wgmma`'s
//   register-A layout, so P never touches shared memory. V is the B
//   operand, read MN-major through the transpose bit.
// - P is f32 and is split into bf16 hi = bf16(p) (ties to even) and
//   lo = bf16(p - hi), two passes into one f32 accumulator, lo first: O
//   keeps the JAX kernel's f32 accuracy, where one bf16 pass would put it
//   ~550-700x further off (tests/test_torch_flash_attention.py). So the
//   route makes 3 passes a tile against the bound's 2: its own floor is
//   1.5x the bound.
// - S of tile i + 1 and P V of tile i are issued together, one commit
//   group each; the softmax of tile i + 1 (mask, row max, exponentials,
//   row sums) runs while P V is in the tensor cores, and O's rescale and
//   P's split follow once it has landed. The descriptors of a tile are a
//   constant add each, and O's rescale is skipped where no row max of
//   the warp moved: each measured ~2% faster than the plain form, with
//   bitwise the same output (PERF.md §6).
// What holds it back on an H100 at its 700 W limit is power, not a unit
// of the SM: under sustained launches nvidia-smi reports the software
// power cap active and the SM clock well below its maximum, and a copy
// with the softmax removed does the same (PERF.md §6, kernels_ab.py
// --sustain). Two warpgroups sharing a ring (half the K/V reads from L2),
// the two taking turns to issue (FlashAttention-3's ping-pong), four
// blocks an SM and Q in registers all measured the same or slower.
//
// f32 route (serving): `flash_fwd_kernel`, both products on `mma.sync`
// m16n8k8 TF32 as 3xTF32: each operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (ties away, as cvt.rna), and
// a product is lo*hi + hi*lo + hi*hi accumulated in f32, which keeps f32's
// accuracy where one TF32 pass would not. Three passes at the 495 TFLOP/s
// TF32 peak bound it. Four consumer warps, each owning 16 query rows, and
// one producer warp, two blocks an SM:
// - The producer's lane 0 loads the query tile once and then every K/V
//   tile with TMA into a ring of shared-memory stages. `full` mbarriers
//   carry TMA's byte count to the consumers; each consumer warp arrives on
//   the stage's `empty` mbarrier when done, which frees it for the next
//   load. There is no block-wide barrier in the key loop. Tiles are stored
//   with TMA's 16-byte swizzle, so the fragment loads are free of bank
//   conflicts.
// - S = Q.K^T: each warp splits its 16 rows of Q once into TF32 hi and lo
//   planes in shared memory and reads both with ldmatrix per k-step; K's
//   fragments are split as they are loaded. Scores, the row max and sum
//   (reduced with quad shuffles) and P stay in registers.
// - P.V: P goes straight from S's accumulator layout into the A fragment:
//   the mma's k index t is key 2t and k index t+4 is key 2t+1, and V's B
//   fragment reads rows 2t and 2t+1 to match, so no shuffle is needed. In
//   32-column boxes a 16-byte load of V gives four n-tiles at once, the
//   n-tiles taking O's columns in the order that makes those loads
//   conflict-free.
// - 64-key tiles in two stages (32 keys in three at D 128).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockQ = 64;  // query rows per block, both routes
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr double kLog2e = 1.44269504088896340736;

// ---- f32 route: 3xTF32 on mma.sync ----------------------------------------------

constexpr int kConsumerWarps = kBlockQ / 16;
constexpr int kThreads = (kConsumerWarps + 1) * 32;

template <int D>
struct Cfg {
  static constexpr int kBlockK = D == 128 ? 32 : 64;
  static constexpr int kStages = D == 128 ? 3 : 2;
  // columns per TMA box: one swizzle span of at most 128 bytes
  static constexpr int kChunk = D > 32 ? 32 : D;
  static constexpr int kRowBytes = kChunk * 4;
  static constexpr int kQBytes = kBlockQ * D * 4;      // Q's hi plane, then its lo plane
  static constexpr int kKVBytes = kBlockK * D * 4;     // K or V, one stage
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages);
  // V's B fragments four n-tiles per 16-byte load
  static constexpr bool kVecV = kChunk == 32;
  static_assert(kBlockQ * kRowBytes % 1024 == 0 && kBlockK * kRowBytes % 1024 == 0,
                "every box must start on a 1024-byte swizzle boundary");
};

// four 8x8 b16 matrices, read here as four 8-row x 4-float tiles: lane
// 8m + r gives the address of row r of matrix m and gets word lane % 4 of
// row lane / 4 of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b on one 16x8x8 tile, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (a_lo * b_hi + a_hi * b_lo) + a_hi * b_hi: 3xTF32
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma(d, a_lo, b_hi[0], b_hi[1]);
  mma(d, a_hi, b_lo[0], b_lo[1]);
  mma(d, a_hi, b_hi[0], b_hi[1]);
}

template <int kChunk, int kRows>
__device__ __forceinline__ float tile_at(const unsigned char* tile, int row, int col) {
  return *reinterpret_cast<const float*>(tile + tile_off<float, kChunk, kRows>(row, col));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                 float* __restrict__ lse, int n_bh, int seq_len, int heads,
                 float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int BK = C::kBlockK, kStages = C::kStages, kChunk = C::kChunk;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* q_s = smem;                    // Q, then Q's hi plane
  unsigned char* q_lo_s = smem + C::kQBytes;    // Q's lo plane
  unsigned char* kv_s = q_lo_s + C::kQBytes;    // stage s: K at 2s, V at 2s+1 (kKVBytes each)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bh, rank;  // high query tiles walk the most key tiles
  const int n_qt = (seq_len + kBlockQ - 1) / kBlockQ;
  if (!block_work(n_bh, n_qt, bh, rank)) return;
  const int q0 = (n_qt - 1 - rank) * kBlockQ;
  const int b = bh / heads, h = bh - b * heads;
  int n_kt = (seq_len + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + kBlockQ + BK - 1) / BK);  // later tiles fully masked

  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzle assumes 1024-byte boxes
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < D / kChunk; ++c)
        tma_load(q_s + c * kBlockQ * C::kRowBytes, &q_map, q_full, c * kChunk, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        unsigned char* k_s = kv_s + 2 * s * C::kKVBytes;
        unsigned char* v_s = k_s + C::kKVBytes;
        mbar_expect_tx(&full[s], 2 * C::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / kChunk; ++c) {
          tma_load(k_s + c * BK * C::kRowBytes, &k_map, &full[s], c * kChunk, h, kt * BK, b);
          tma_load(v_s + c * BK * C::kRowBytes, &v_map, &full[s], c * kChunk, h, kt * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warp w owns query rows r0 .. r0+15 of the tile; lane
  // (g, t) = (lane / 4, lane % 4) holds rows g and g+8 of each fragment;
  // for ldmatrix, lane (lm, lr) = (lane / 8, lane % 8) addresses row lr
  // of matrix lm
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int lm = lane >> 3, lr = lane & 7;

  mbar_wait(q_full, 0);
  // this warp's rows of Q: hi in place, lo beside
  for (int e = lane; e < 16 * D; e += 32) {
    const int off = tile_off<float, kChunk, kBlockQ>(r0 + e / D, e % D);
    uint32_t hi, lo;
    split(*reinterpret_cast<const float*>(q_s + off), hi, lo);
    *reinterpret_cast<uint32_t*>(q_s + off) = hi;
    *reinterpret_cast<uint32_t*>(q_lo_s + off) = lo;
  }
  __syncwarp();
  // Q's A fragments at k-step ks: rows r0+g, r0+g+8 x columns 8ks+t, 8ks+t+4
  auto q_frag = [&](int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int off = tile_off<float, kChunk, kBlockQ>(r0 + lr + (lm & 1) * 8, ks * 8 + (lm >> 1) * 4);
    ldsm4(hi, q_s + off);
    ldsm4(lo, q_lo_s + off);
  };
  // K's B fragments (b0, b1) of n-tiles n and n+1 at k-step ks, hi and lo
  auto k_frags = [&](const unsigned char* k_s, int ks, int n, uint32_t (&hi)[2][2],
                     uint32_t (&lo)[2][2]) {
    uint32_t r[4];
    ldsm4(r, k_s + tile_off<float, kChunk, BK>((n + (lm >> 1)) * 8 + lr, ks * 8 + (lm & 1) * 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), hi[i >> 1][i & 1], lo[i >> 1][i & 1]);
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // running sum, this lane's columns only

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* k_s = kv_s + 2 * s * C::kKVBytes;
    const unsigned char* v_s = k_s + C::kKVBytes;

    // S = Q K^T over this tile: sc[n] holds keys 8n + 2t, 8n + 2t + 1
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      uint32_t a_hi[4], a_lo[4];
      q_frag(ks, a_hi, a_lo);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t b_hi[2][2], b_lo[2][2];
        k_frags(k_s, ks, n, b_hi, b_lo);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma3(sc[n + j], a_hi, a_lo, b_hi[j], b_lo[j]);
      }
    }

    // scale to log2 units, mask, online softmax; rows g (i = 0, 1) and
    // g + 8 (i = 2, 3)
    const int k0 = kt * BK;
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > seq_len;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[n][i] * scale_log2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (i & 1);
          const int row = q0 + r0 + g + (i >> 1) * 8;
          if (key >= seq_len || (causal && key > row)) x = kNegInf;
        }
        sc[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float corr = exp2_ftz(m[j] - mx[j]);
      m[j] = mx[j];
      l[j] *= corr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * j] *= corr;
        acc[n][2 * j + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2_ftz(sc[n][i] - m[i >> 1]);
        sc[n][i] = p;
        l[i >> 1] += p;
      }

    // O += P V over key steps of 8: the mma's k index t is key 2t and k
    // index t+4 is key 2t+1, so P's A fragment is S's accumulator
    // {c0, c2, c1, c3} and V's B fragment reads rows 2t and 2t+1
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t p_hi[4], p_lo[4];
      split(sc[kk][0], p_hi[0], p_lo[0]);
      split(sc[kk][2], p_hi[1], p_lo[1]);
      split(sc[kk][1], p_hi[2], p_lo[2]);
      split(sc[kk][3], p_hi[3], p_lo[3]);
      if constexpr (C::kVecV) {
        // n-tile 4x + e takes O's columns 32x + 4g + e, so that the 16
        // bytes at columns 32x + 4g .. +3 of rows 2t, 2t+1 feed four
        // n-tiles (conflict-free: the swizzle puts the 8 lanes of a
        // phase on 8 distinct 16-byte units)
#pragma unroll
        for (int x = 0; x < D / 32; ++x) {
          float4 v4[2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            v4[r] = *reinterpret_cast<const float4*>(
                v_s + tile_off<float, kChunk, BK>(kk * 8 + 2 * t + r, 32 * x + 4 * g));
          const float x0[4] = {v4[0].x, v4[0].y, v4[0].z, v4[0].w};
          const float x1[4] = {v4[1].x, v4[1].y, v4[1].z, v4[1].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t b_hi[2], b_lo[2];
            split(x0[e], b_hi[0], b_lo[0]);
            split(x1[e], b_hi[1], b_lo[1]);
            mma3(acc[4 * x + e], p_hi, p_lo, b_hi, b_lo);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b_hi[2], b_lo[2];
          split(tile_at<kChunk, BK>(v_s, kk * 8 + 2 * t, n * 8 + g), b_hi[0], b_lo[0]);
          split(tile_at<kChunk, BK>(v_s, kk * 8 + 2 * t + 1, n * 8 + g), b_hi[1], b_lo[1]);
          mma3(acc[n], p_hi, p_lo, b_hi, b_lo);
        }
      }
    }

    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  // epilogue: finish each row's sum across its quad, then O and lse
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    const int row = q0 + r0 + g + 8 * j;
    if (row >= seq_len) continue;
    const float lj = fmaxf(l[j], 1e-30f);
    if (t == 0) lse[(long long)bh * seq_len + row] = m[j] * kLn2 + logf(lj);
    // O is allocated contiguous [B, T, H, D]
    float* orow = o + (((long long)b * seq_len + row) * heads + h) * D;
    if constexpr (C::kVecV) {  // columns 32x + 8t .. +3 (c0) and +4 .. +7 (c1)
#pragma unroll
      for (int x = 0; x < D / 32; ++x) {
        float* dst = orow + 32 * x + 8 * t;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          *reinterpret_cast<float4*>(dst + 4 * c) = make_float4(
              acc[4 * x][2 * j + c] / lj, acc[4 * x + 1][2 * j + c] / lj,
              acc[4 * x + 2][2 * j + c] / lj, acc[4 * x + 3][2 * j + c] / lj);
      }
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
            make_float2(acc[n][2 * j] / lj, acc[n][2 * j + 1] / lj);
    }
  }
}

// ---- bf16 route: wgmma + TMA ------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup, which feeds its own ring

template <int D>
struct WgCfg {
  static constexpr int kBK = 64;                     // keys per tile
  // K/V ring stages: a tile's stage is refilled in the iteration after it
  // was read, so four stages load two tiles ahead (three, at D 128, fill
  // the shared memory of two blocks)
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;       // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + kStages);
  // blocks per SM: three warpgroups at 168 registers a thread, two at D
  // 128 (O's accumulators take 64)
  static constexpr int kMinBlocks = D == 128 ? 2 : 3;
  static_assert(kBK * Bf16Tile<D>::kRowBytes % 1024 == 0 &&
                    kBlockQ * Bf16Tile<D>::kRowBytes % 1024 == 0,
                "every box must start on a 1024-byte swizzle boundary");
};

// O and lse of one 64-query tile of one (b, h). Thread (warp w, lane
// 4g + t) owns queries 16w + g and 16w + g + 8 of the tile; its S
// accumulators hold keys 8j + 2t and 8j + 2t + 1, its O accumulators
// columns 8j + 2t and 8j + 2t + 1.
template <int D>
__global__ void __launch_bounds__(kWgThreads, WgCfg<D>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int n_bh, int seq_len, int heads,
                       float scale_log2, int causal) {
  using C = WgCfg<D>;
  constexpr int BQ = kBlockQ, BK = C::kBK, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char tiles[];  // TMA boxes, then barriers
  unsigned char* smem = tiles;
  unsigned char* q_s = smem;                   // Q: resident
  unsigned char* ring = smem + C::kQBytes;     // stage s: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bh, rank;  // high query tiles walk the most key tiles
  const int n_qt = (seq_len + BQ - 1) / BQ;
  if (!block_work(n_bh, n_qt, bh, rank)) return;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (n_qt - 1 - rank) * BQ;
  int n_tiles = (seq_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);  // later tiles fully masked
  init_barriers<kStages, 1>(smem, bars);
  auto stage = [&](int i) { return ring + (i % kStages) * 2 * C::kKVBytes; };
  // Q and the ring's first tiles; each later tile is loaded when its
  // stage is freed in the loop
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars, C::kQBytes);
    tma_tile<D, BQ>(&q_map, q_s, bars, b, h, q0);
    for (int i = 0; i < kStages && i < n_tiles; ++i)
      load_pair<D, BK>(&k_map, &v_map, stage(i), bars + 1 + i % kStages, b, h, i * BK);
  }

  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's queries: row0, row0 + 8
  float acc[D / 2], sc[BK / 2];
  uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
  zero(acc);
  zero(sc);
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // running sum, this thread's columns only
  float corr[2];                    // O's rescale for the max's last step

  // the descriptors of Q and of stage 0's K and V at k-step 0; a stage
  // and a k-step move them by constant offsets, so a tile's descriptors
  // cost an add each, not the issue slots of building them
  const uint64_t q_desc = kmajor_desc<D, BQ>(q_s, 0);
  const uint64_t k_desc = kmajor_desc<D, BK>(ring, 0);
  const uint64_t v_desc = mnmajor_desc<D, BK>(ring + C::kKVBytes, 0);
  auto stage_bytes = [](int i) { return (i % kStages) * 2 * C::kKVBytes; };
  // S = Q K^T of tile i into sc (issued, not waited for)
  auto issue_scores = [&](int i) {
    const uint64_t d = desc_add(k_desc, stage_bytes(i));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(sc, desc_add(q_desc, kmajor_step<D, BQ>(ks)),
                  desc_add(d, kmajor_step<D, BK>(ks)), ks > 0);
  };
  // O += P V of tile i, lo then hi, B = V MN-major (issued, not waited for)
  auto issue_pv = [&](int i) {
    const uint64_t d = desc_add(v_desc, stage_bytes(i));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t v_d = desc_add(d, mnmajor_step<D>(kk));
      wgmma_rs<1>(acc, p_lo[kk], v_d);
      wgmma_rs<1>(acc, p_hi[kk], v_d);
    }
  };
  // The online softmax of tile i's scores: mask, the new row max (quad
  // shuffles), corr, P = exp2(s * scale_log2 - m * scale_log2) in place
  // of S, and l rescaled and summed. Element 4j + e is query row0 +
  // 8(e >> 1), key k0 + 8j + 2t + (e & 1).
  auto softmax = [&](int i) {
    const int k0 = i * BK;
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > seq_len) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), q = row0 + 8 * (e >> 1);
          if (key >= seq_len || (causal && key > q)) sc[4 * j + e] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    float ms[2];
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
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -ms[e >> 1]));
        sc[4 * j + e] = p;
        l[e >> 1] += p;
      }
  };
  // P's bf16 hi/lo register-A operands: k-step kk is keys 16kk .. 16kk+15
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], p_hi[kk][r], p_lo[kk][r]);
  };

  mbar_wait(bars, 0);
  mbar_wait(bars + 1, 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  // Iteration i: O to tile i's max and P_i's operands once P V of tile
  // i - 1 has landed, then S of tile i + 1 and P V of tile i issued, and
  // the softmax of tile i + 1 while P V runs. The wait for P V opens the
  // next iteration: the loop's back edge keeps ptxas from hoisting it
  // above the softmax, which it does within one basic block (the
  // rescale and the split write registers the products own).
  for (int i = 0; i < n_tiles; ++i) {
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    // O to tile i's max, unless no row max of this warp moved (corr 1
    // leaves O as it is)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
    }
    split_p();
    if (i > 0 && i - 1 + kStages < n_tiles) {  // tile i - 1's stage is free: refill it
      __syncthreads();
      if (threadIdx.x == 0)
        load_pair<D, BK>(&k_map, &v_map, stage(i - 1), bars + 1 + (i - 1) % kStages, b, h,
                         (i - 1 + kStages) * BK);
    }
    if (i + 1 < n_tiles) {
      mbar_wait(bars + 1 + (i + 1) % kStages, ((i + 1) / kStages) & 1);
      wgmma_fence();
      issue_scores(i + 1);
      wgmma_commit();
      issue_pv(i);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(i + 1);  // while P V of tile i is in the tensor cores
    } else {
      wgmma_fence();
      issue_pv(i);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: finish each row's sum across its quad, then O and lse
  const long long lrow = (long long)bh * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int q = row0 + 8 * r;
    if (q >= seq_len) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    if (t == 0) lse[lrow + q] = m[r] * scale_log2 * kLn2 + logf(lr);
    __nv_bfloat16* out = o + (((long long)b * seq_len + q) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / lr, acc[4 * j + 2 * r + 1] / lr);
  }
}

// ---- host side -------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void *o;
  float* lse;
  int batch, seq_len, heads;
  Strides qs, ks, vs;
  float scale_log2;
  int causal;
  cudaStream_t stream;
};

template <int D>
int launch_f32(const Args& a) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map;
  const int B = a.batch, T = a.seq_len, H = a.heads;
  int rc = encode<float>(&q_map, a.q, B, T, H, D, a.qs, C::kChunk, kBlockQ);
  if (rc == 0) rc = encode<float>(&k_map, a.k, B, T, H, D, a.ks, C::kChunk, C::kBlockK);
  if (rc == 0) rc = encode<float>(&v_map, a.v, B, T, H, D, a.vs, C::kChunk, C::kBlockK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = work_grid(B * H, (T + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D><<<grid, kThreads, C::kSmemBytes, a.stream>>>(
      q_map, k_map, v_map, static_cast<float*>(a.o), a.lse, B * H, T, H, a.scale_log2,
      a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a) {
  using C = WgCfg<D>;
  using bf16 = __nv_bfloat16;
  constexpr int kChunk = Bf16Tile<D>::kChunk;
  CUtensorMap q_map, k_map, v_map;
  const int B = a.batch, T = a.seq_len, H = a.heads;
  int rc = encode<bf16>(&q_map, a.q, B, T, H, D, a.qs, kChunk, kBlockQ);
  if (rc == 0) rc = encode<bf16>(&k_map, a.k, B, T, H, D, a.ks, kChunk, C::kBK);
  if (rc == 0) rc = encode<bf16>(&v_map, a.v, B, T, H, D, a.vs, kChunk, C::kBK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = work_grid(B * H, (T + kBlockQ - 1) / kBlockQ);
  flash_fwd_wgmma_kernel<D><<<grid, kWgThreads, C::kSmemBytes, a.stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(a.o), a.lse, B * H, T, H, a.scale_log2,
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

// dtype: 0 = float32, 1 = bfloat16. Every pointer and every stride of a
// dimension longer than 1, in bytes, must be a multiple of 16 (TMA's
// rule; the Python wrapper sees to it). Returns 0 on success, else a
// CUDA error code of the launch or a tensor-map code of hopper.cuh; the
// caller raises on anything but 0.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int dtype, int batch, int seq_len, int heads, int head_dim,
                        long long q_sb, long long q_st, long long q_sh, long long k_sb,
                        long long k_st, long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, float scale, int causal, void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, seq_len, heads,
               Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh},
               (float)(scale * kLog2e), causal, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a);
}

const char* flash_attention_error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
