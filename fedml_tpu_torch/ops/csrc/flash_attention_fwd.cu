// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (fedml_tpu/ops/flash_attention.py:32, launched by `_flash_forward` at
// :68 through pl.pallas_call at :83). Same function: scaled-dot-product
// attention over [B, T, H, D] inputs with an online softmax carried in
// f32 across key tiles, causal masking with -1e30, fully masked key tiles
// skipped, and two outputs: O [B, T, H, D] in the input dtype and the
// per-row log-sum-exp lse = m + log(max(l, 1e-30)) as f32 [B, H, T].
//
// Bound on an H100: causal attention at the serving shapes (T 4096, D 64)
// does ~2*T*D flops per byte it must move, far above the card's balance
// point, so it is bound by operations. Both products run on the tensor
// cores (mma.sync m16n8k8 tf32). f32 inputs take 3xTF32: each operand x
// is split into hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest (ties away, as cvt.rna), and a product is lo*hi + hi*lo + hi*hi
// accumulated in f32, which keeps f32's accuracy where one TF32 pass
// would not. Three passes at the 495 TFLOP/s TF32 peak bound it. bf16
// inputs are exact in TF32, so their lo terms vanish: Q.K^T is one pass
// and P.V two (P is f32, V exact).
//
// Design. One block per (64-row query tile, batch*head): four consumer
// warps, each owning 16 query rows, and one producer warp.
// - The producer's lane 0 loads the query tile once and then every K/V
//   tile with TMA (cp.async.bulk.tensor, 4-D tensor maps over the
//   [B, T, H, D] strides, so the q/k/v views of a fused projection need
//   no copy) into a ring of shared-memory stages. `full` mbarriers carry
//   TMA's byte count to the consumers; each consumer warp arrives on the
//   stage's `empty` mbarrier when done, which frees it for the next load.
//   There is no block-wide barrier in the key loop. Rows past the
//   sequence end arrive zero-filled (TMA's out-of-bounds fill).
// - Tiles are stored with TMA's 16-byte swizzle (128 B rows, or 64/32 B
//   for narrow heads), so the fragment loads below are free of bank
//   conflicts.
// - S = Q.K^T. A = Q: in f32 each warp splits its 16 rows once into TF32
//   hi and lo planes in shared memory and reads both with ldmatrix per
//   k-step; bf16 Q is held in registers. B = K: ldmatrix (f32), split as
//   it is loaded. Scores, the row max and sum (reduced with quad
//   shuffles) and P stay in registers, in log2 units (scale * log2(e)
//   folded into one multiply) so each weight is one ex2.
// - P.V. P goes straight from S's accumulator layout into the A
//   fragment: the mma's k index t is key 2t and k index t+4 is key 2t+1,
//   and V's B fragment reads rows 2t and 2t+1 to match, so no shuffle is
//   needed. In f32 (32-column boxes) a 16-byte load of V gives four
//   n-tiles at once, the n-tiles taking O's columns in the order that
//   makes those loads conflict-free.
// - 64-key tiles in two stages (32 keys in three at D 128): two blocks
//   fit on an SM. The grid puts batch*head on x and the query tile on y,
//   so any batch*head up to 2^31 - 1 launches; `block_work` hands blocks
//   out a few heads at a time, longest causal tiles first. TMA, mbarrier,
//   tensor-map and block-order helpers come from hopper.cuh.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockQ = 64;
constexpr int kConsumerWarps = kBlockQ / 16;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr double kLog2e = 1.44269504088896340736;

template <typename T, int D>
struct Cfg {
  static constexpr bool kSplit = std::is_same<T, float>::value;  // 3xTF32 operands
  static constexpr int kBlockK = D == 128 ? 32 : 64;
  static constexpr int kStages = D == 128 ? 3 : 2;
  // columns per TMA box: one swizzle span of at most 128 bytes
  static constexpr int kChunk = D * (int)sizeof(T) > 128 ? 128 / (int)sizeof(T) : D;
  static constexpr int kRowBytes = kChunk * (int)sizeof(T);
  static constexpr int kQBytes = kBlockQ * D * (int)sizeof(T);
  static constexpr int kQLoBytes = kSplit ? kQBytes : 0;         // Q's lo plane
  static constexpr int kKVBytes = kBlockK * D * (int)sizeof(T);  // K or V, one stage
  static constexpr int kBarOffset = kQBytes + kQLoBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages);
  // V's B fragments four n-tiles per 16-byte load
  static constexpr bool kVecV = kSplit && kChunk == 32;
  static_assert(kBlockQ * kRowBytes % 1024 == 0 && kBlockK * kRowBytes % 1024 == 0,
                "every box must start on a 1024-byte swizzle boundary");
};

// ---- PTX wrappers ----------------------------------------------------------

// four 8x8 b16 matrices, read here as four 8-row x 4-float tiles: lane
// 8m + r gives the address of row r of matrix m and gets word lane % 4 of
// row lane / 4 of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32. Adding half a TF32 ulp to the
// magnitude bits and clearing the low 13 is two integer instructions;
// cvt.rna compiles to four (it also guards Inf and NaN, which reach the
// output as NaN through x - hi here all the same).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 relative, both exact TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int kChunk, int kRows>
__device__ __forceinline__ float tile_at(const unsigned char* tile, int row, int col) {
  return to_f32(*reinterpret_cast<const T*>(tile + tile_off<T, kChunk, kRows>(row, col)));
}

// ---- kernel ----------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, T* __restrict__ o,
                 float* __restrict__ lse, int seq_len, int heads, float scale_log2,
                 int causal) {
  using C = Cfg<T, D>;
  constexpr int BK = C::kBlockK, kStages = C::kStages, kChunk = C::kChunk;
  constexpr bool kSplit = C::kSplit;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* q_s = smem;                    // Q, then (f32) Q's hi plane
  unsigned char* q_lo_s = smem + C::kQBytes;    // f32: Q's lo plane
  unsigned char* kv_s = q_lo_s + C::kQLoBytes;  // stage s: K at 2s, V at 2s+1 (kKVBytes each)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bh, rank;  // high query tiles walk the most key tiles
  block_work(bh, rank);
  const int q0 = (gridDim.y - 1 - rank) * kBlockQ;
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
  // Q's A fragments: rows r0+g, r0+g+8 x columns 8ks+t, 8ks+t+4
  uint32_t q_reg[kSplit ? 1 : D / 8][4];
  if constexpr (kSplit) {  // this warp's rows: hi in place, lo beside
    for (int e = lane; e < 16 * D; e += 32) {
      const int off = tile_off<T, kChunk, kBlockQ>(r0 + e / D, e % D);
      uint32_t hi, lo;
      split(*reinterpret_cast<const float*>(q_s + off), hi, lo);
      *reinterpret_cast<uint32_t*>(q_s + off) = hi;
      *reinterpret_cast<uint32_t*>(q_lo_s + off) = lo;
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q_reg[ks][i] = __float_as_uint(tile_at<T, kChunk, kBlockQ>(
            q_s, r0 + g + (i & 1) * 8, ks * 8 + t + (i >> 1) * 4));
  }
  auto q_frag = [&](int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    if constexpr (kSplit) {
      const int off =
          tile_off<T, kChunk, kBlockQ>(r0 + lr + (lm & 1) * 8, ks * 8 + (lm >> 1) * 4);
      ldsm4(hi, q_s + off);
      ldsm4(lo, q_lo_s + off);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) hi[i] = q_reg[ks][i];
    }
  };
  // K's B fragments (b0, b1) of n-tiles n and n+1 at k-step ks, hi and lo
  auto k_frags = [&](const unsigned char* k_s, int ks, int n, uint32_t (&hi)[2][2],
                     uint32_t (&lo)[2][2]) {
    if constexpr (kSplit) {
      uint32_t r[4];
      ldsm4(r, k_s + tile_off<T, kChunk, BK>((n + (lm >> 1)) * 8 + lr, ks * 8 + (lm & 1) * 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), hi[i >> 1][i & 1], lo[i >> 1][i & 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hi[i >> 1][i & 1] = __float_as_uint(
            tile_at<T, kChunk, BK>(k_s, (n + (i >> 1)) * 8 + g, ks * 8 + t + (i & 1) * 4));
    }
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
        for (int j = 0; j < 2; ++j) {
          if constexpr (kSplit) mma3(sc[n + j], a_hi, a_lo, b_hi[j], b_lo[j]);
          else mma(sc[n + j], a_hi, b_hi[j][0], b_hi[j][1]);
        }
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
                v_s + tile_off<T, kChunk, BK>(kk * 8 + 2 * t + r, 32 * x + 4 * g));
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
          const float x0 = tile_at<T, kChunk, BK>(v_s, kk * 8 + 2 * t, n * 8 + g);
          const float x1 = tile_at<T, kChunk, BK>(v_s, kk * 8 + 2 * t + 1, n * 8 + g);
          uint32_t b_hi[2], b_lo[2];
          if constexpr (kSplit) {
            split(x0, b_hi[0], b_lo[0]);
            split(x1, b_hi[1], b_lo[1]);
            mma3(acc[n], p_hi, p_lo, b_hi, b_lo);
          } else {  // V exact in TF32
            mma(acc[n], p_lo, __float_as_uint(x0), __float_as_uint(x1));
            mma(acc[n], p_hi, __float_as_uint(x0), __float_as_uint(x1));
          }
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
    T* orow = o + (((long long)b * seq_len + row) * heads + h) * D;
    if constexpr (C::kVecV) {  // columns 32x + 8t .. +3 (c0) and +4 .. +7 (c1)
#pragma unroll
      for (int x = 0; x < D / 32; ++x) {
        float* dst = reinterpret_cast<float*>(orow) + 32 * x + 8 * t;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          *reinterpret_cast<float4*>(dst + 4 * c) = make_float4(
              acc[4 * x][2 * j + c] / lj, acc[4 * x + 1][2 * j + c] / lj,
              acc[4 * x + 2][2 * j + c] / lj, acc[4 * x + 3][2 * j + c] / lj);
      }
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(orow + n * 8 + 2 * t, acc[n][2 * j] / lj, acc[n][2 * j + 1] / lj);
    }
  }
}

// ---- host side -------------------------------------------------------------

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int seq_len, int heads, Strides qs, Strides ks, Strides vs, float scale,
           int causal, cudaStream_t stream) {
  using C = Cfg<T, D>;
  CUtensorMap q_map, k_map, v_map;
  int rc = encode<T>(&q_map, q, batch, seq_len, heads, D, qs, C::kChunk, kBlockQ);
  if (rc == 0) rc = encode<T>(&k_map, k, batch, seq_len, heads, D, ks, C::kChunk, C::kBlockK);
  if (rc == 0) rc = encode<T>(&v_map, v, batch, seq_len, heads, D, vs, C::kChunk, C::kBlockK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (seq_len + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, C::kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(o), lse, seq_len, heads,
      (float)(scale * kLog2e), causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v, void* o,
                 float* lse, int batch, int seq_len, int heads, Strides qs, Strides ks,
                 Strides vs, float scale, int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, batch, seq_len, heads, qs, ks, vs, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, batch, seq_len, heads, qs, ks, vs, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch, seq_len, heads, qs, ks, vs, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch, seq_len, heads, qs, ks, vs, scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every pointer and every stride of a
// dimension longer than 1, in bytes, must be a multiple of 16 (TMA's
// rule; the Python wrapper sees to it). Returns 0 on success, else a
// CUDA error code of the launch or one of the negative codes above; the
// caller raises on anything but 0.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int dtype, int batch, int seq_len, int heads, int head_dim,
                        long long q_sb, long long q_st, long long q_sh, long long k_sb,
                        long long k_st, long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, float scale, int causal, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(head_dim, q, k, v, o, lse_f, batch, seq_len, heads, qs, ks,
                               vs, scale, causal, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, o, lse_f, batch, seq_len, heads,
                                       qs, ks, vs, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
