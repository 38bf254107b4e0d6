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
// (up to 2^31 - 1) and the tile on y, low key tiles and high query tiles
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
// f32 route: the same three kernels in `mma.sync` m16n8k8 TF32, f32
// operands in shared-memory tiles loaded by all threads, P and dS through
// shared memory. Every product is 3xTF32 (lo*hi + hi*lo
// + hi*hi of x = hi + lo, both TF32), which keeps f32's accuracy where
// one TF32 pass would not. Shared-memory rows are padded (Q, K, V, dO by 4
// floats; P and dS by 8 in the dK/dV kernel, where they are read
// transposed; dS by 4 in the dQ kernel), so each fragment load of a warp
// touches 32 distinct banks where the access is row-major and at most 2
// lanes share a bank where it is transposed.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;  // queries and keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Cfg {
  static constexpr int kLd = D + 4;      // row stride (floats) of the Q, K, V, dO tiles
  static constexpr int kPLd = kTile + 8; // P, dS rows in the dK/dV kernel (read transposed)
  static constexpr int kSLd = kTile + 4; // dS rows in the dQ kernel (read row-wise)
  static constexpr int kNt = D / 16;     // n-tiles of 8 columns per warp: half of D
  static constexpr int kTileBytes = kTile * kLd * 4;
  static constexpr int kDkdvSmem = 4 * kTileBytes + 2 * kTile * kPLd * 4 + 2 * kTile * 4;
  static constexpr int kDqSmem = 4 * kTileBytes + kTile * kSLd * 4 + 2 * kTile * 4;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
};

// ---- f32 route: arithmetic ------------------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero (cvt.rna's rounding; two integer instructions)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 relative, both exact TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a * b on one 16x8x8 tile, f32 accumulate. Fragments (g, t) =
// (lane / 4, lane % 4): A holds (row, col) (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); B holds (k, n) (t, g), (t+4, g); C holds (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand fragment read from an f32 tile: its TF32 hi and lo parts.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ void make_frag(Frag<N>& f, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], f.hi[i], f.lo[i]);
}

// d += a * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_x(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma(d, a.lo, b.hi[0], b.hi[1]);
  mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// ---- f32 route: tiles -----------------------------------------------------------

// Rows t0 .. t0+63 of (b, h) of a [B, T, H, D] f32 input into a tile of
// row stride kLd; rows at or past seq_len are zero. The wrapper guarantees
// a 16-byte-aligned base and 16-byte-multiple strides.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides s,
                                          int b, int h, int t0, int seq_len) {
  constexpr int kPerRow = D / 4;
  const float* base = src + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const int t = t0 + r;
    *reinterpret_cast<float4*>(dst + r * Cfg<D>::kLd + c) =
        t < seq_len ? *reinterpret_cast<const float4*>(base + t * s.t + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// lse and delta of rows t0 .. t0+63 of row block `bh` ([B, H, T] f32)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, long long bh,
                                          int t0, int seq_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int t = t0 + r;
    lse_s[r] = t < seq_len ? lse[bh * seq_len + t] : 0.f;
    delta_s[r] = t < seq_len ? delta[bh * seq_len + t] : 0.f;
  }
}

// Phase A, shared by the dK/dV and dQ kernels: this warp's 16 query rows
// (qr0 ..) x 32 keys (kc0 ..) of the tile pair, S = Q K^T and dP = dO V^T,
// then P and dS in place of them. Rows and keys are tile-local; q0, k0
// place the tiles in the sequence.
template <int D>
__device__ __forceinline__ void scores(const float* q_s, const float* k_s, const float* do_s,
                                       const float* v_s, const float* lse_s,
                                       const float* delta_s, int qr0, int kc0, int q0, int k0,
                                       int seq_len, int causal, float scale,
                                       float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int ld = Cfg<D>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[n][i] = ds[n][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    float xq[4], xdo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = (qr0 + g + (i & 1) * 8) * ld + ks * 8 + t + (i >> 1) * 4;
      xq[i] = q_s[off];
      xdo[i] = do_s[off];
    }
    Frag<4> aq, ado;
    make_frag(aq, xq);
    make_frag(ado, xdo);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float xk[2], xv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = (kc0 + n * 8 + g) * ld + ks * 8 + t + j * 4;
        xk[j] = k_s[off];
        xv[j] = v_s[off];
      }
      Frag<2> bk, bv;
      make_frag(bk, xk);
      make_frag(bv, xv);
      mma_x(p[n], aq, bk);   // S
      mma_x(ds[n], ado, bv); // dP
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = qr0 + g + (i >> 1) * 8;  // tile-local query row
      const int row = q0 + r, key = k0 + kc0 + n * 8 + 2 * t + (i & 1);
      const bool keep = row < seq_len && key < seq_len && (!causal || key <= row);
      const float pv = keep ? expf(p[n][i] * scale - lse_s[r]) : 0.f;
      p[n][i] = pv;
      ds[n][i] = pv * (ds[n][i] - delta_s[r]) * scale;
    }
}

// ---- kernels: delta and the f32 route -------------------------------------------

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

// dK and dV of one 64-key tile of one (b, h)
template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv,
            Strides qs, Strides ks, Strides vs, Strides dos, int seq_len, int heads,
            float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * C::kLd;
  float* q_s = v_s + kTile * C::kLd;
  float* do_s = q_s + kTile * C::kLd;
  float* p_s = do_s + kTile * C::kLd;
  float* ds_s = p_s + kTile * C::kPLd;
  float* lse_s = ds_s + kTile * C::kPLd;
  float* delta_s = lse_s + kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int bh, kt;  // low key tiles walk the most causal query tiles
  block_work(bh, kt);
  const int b = bh / heads, h = bh - b * heads;
  const int k0 = kt * kTile;
  const int n_qt = (seq_len + kTile - 1) / kTile;
  const int qt0 = causal ? kt : 0;  // earlier query tiles see none of these keys

  load_tile<D>(k_s, k, ks, b, h, k0, seq_len);
  load_tile<D>(v_s, v, vs, b, h, k0, seq_len);

  // phase A: query rows qa0.., keys kc0..; phase B: keys kb0.., columns dc0..
  const int qa0 = (warp & 3) * 16, kc0 = (warp >> 2) * 32;
  const int kb0 = (warp & 3) * 16, dc0 = (warp >> 2) * (D / 2);
  float acc_dk[C::kNt][4], acc_dv[C::kNt][4];
#pragma unroll
  for (int n = 0; n < C::kNt; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[n][i] = acc_dv[n][i] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    load_tile<D>(q_s, q, qs, b, h, q0, seq_len);
    load_tile<D>(do_s, dout, dos, b, h, q0, seq_len);
    load_rows(lse_s, delta_s, lse, delta, bh, q0, seq_len);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<D>(q_s, k_s, do_s, v_s, lse_s, delta_s, qa0, kc0, q0, k0, seq_len, causal,
                      scale, p, ds);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = (qa0 + g + 8 * j) * C::kPLd + kc0 + n * 8 + 2 * t;
        store2(p_s + off, p[n][2 * j], p[n][2 * j + 1]);
        store2(ds_s + off, ds[n][2 * j], ds[n][2 * j + 1]);
      }
    __syncthreads();

    // phase B: dV += P^T dO and dK += dS^T Q over the tile's 64 queries.
    // A[m = key][k = query] = P[query][key]; B[k = query][n = col] = dO / Q.
#pragma unroll 2
    for (int kk = 0; kk < kTile / 8; ++kk) {
      float xp[4], xds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (kk * 8 + t + (i >> 1) * 4) * C::kPLd + kb0 + g + (i & 1) * 8;
        xp[i] = p_s[off];
        xds[i] = ds_s[off];
      }
      Frag<4> ap, ads;
      make_frag(ap, xp);
      make_frag(ads, xds);
#pragma unroll
      for (int n = 0; n < C::kNt; ++n) {
        float xdo[2], xq[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int off = (kk * 8 + t + j * 4) * C::kLd + dc0 + n * 8 + g;
          xdo[j] = do_s[off];
          xq[j] = q_s[off];
        }
        Frag<2> bdo, bq;
        make_frag(bdo, xdo);
        make_frag(bq, xq);
        mma_x(acc_dv[n], ap, bdo);
        mma_x(acc_dk[n], ads, bq);
      }
    }
    __syncthreads();  // the next tile overwrites Q, dO, P and dS
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = k0 + kb0 + g + 8 * j;
    if (key >= seq_len) continue;
    const long long row = (((long long)b * seq_len + key) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < C::kNt; ++n) {
      const int col = dc0 + n * 8 + 2 * t;
      store2(dk + row + col, acc_dk[n][2 * j], acc_dk[n][2 * j + 1]);
      store2(dv + row + col, acc_dv[n][2 * j], acc_dv[n][2 * j + 1]);
    }
  }
}

// dQ of one 64-query tile of one (b, h)
template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, Strides qs, Strides ks,
          Strides vs, Strides dos, int seq_len, int heads, float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * C::kLd;
  float* k_s = do_s + kTile * C::kLd;
  float* v_s = k_s + kTile * C::kLd;
  float* ds_s = v_s + kTile * C::kLd;
  float* lse_s = ds_s + kTile * C::kSLd;
  float* delta_s = lse_s + kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int bh, rank;
  block_work(bh, rank);
  const int b = bh / heads, h = bh - b * heads;
  const int qt = gridDim.y - 1 - rank;  // high query tiles walk the most key tiles
  const int q0 = qt * kTile;
  const int n_kt = causal ? qt + 1 : (seq_len + kTile - 1) / kTile;

  load_tile<D>(q_s, q, qs, b, h, q0, seq_len);
  load_tile<D>(do_s, dout, dos, b, h, q0, seq_len);
  load_rows(lse_s, delta_s, lse, delta, bh, q0, seq_len);

  // phase A: query rows qa0.., keys kc0..; phase C: query rows qa0.., columns dc0..
  const int qa0 = (warp & 3) * 16, kc0 = (warp >> 2) * 32, dc0 = (warp >> 2) * (D / 2);
  float acc[C::kNt][4];
#pragma unroll
  for (int n = 0; n < C::kNt; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<D>(k_s, k, ks, b, h, k0, seq_len);
    load_tile<D>(v_s, v, vs, b, h, k0, seq_len);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<D>(q_s, k_s, do_s, v_s, lse_s, delta_s, qa0, kc0, q0, k0, seq_len, causal,
                      scale, p, ds);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        store2(ds_s + (qa0 + g + 8 * j) * C::kSLd + kc0 + n * 8 + 2 * t, ds[n][2 * j],
               ds[n][2 * j + 1]);
    __syncthreads();

    // phase C: dQ += dS K over the tile's 64 keys.
    // A[m = query][k = key] = dS; B[k = key][n = col] = K.
#pragma unroll 2
    for (int kk = 0; kk < kTile / 8; ++kk) {
      float xds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xds[i] = ds_s[(qa0 + g + (i & 1) * 8) * C::kSLd + kk * 8 + t + (i >> 1) * 4];
      Frag<4> ads;
      make_frag(ads, xds);
#pragma unroll
      for (int n = 0; n < C::kNt; ++n) {
        float xk[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) xk[j] = k_s[(kk * 8 + t + j * 4) * C::kLd + dc0 + n * 8 + g];
        Frag<2> bk;
        make_frag(bk, xk);
        mma_x(acc[n], ads, bk);
      }
    }
    __syncthreads();  // the next tile overwrites K, V and dS
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + qa0 + g + 8 * j;
    if (row >= seq_len) continue;
    float* out = dq + (((long long)b * seq_len + row) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < C::kNt; ++n) {
      const int col = dc0 + n * 8 + 2 * t;
      store2(out + col, acc[n][2 * j], acc[n][2 * j + 1]);
    }
  }
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
                  __nv_bfloat16* __restrict__ dv, int seq_len, int heads, float scale,
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
  block_work(bh, kt);
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
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int seq_len,
                int heads, float scale, int causal) {
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
  block_work(bh, rank);
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (gridDim.y - 1 - rank) * BQ;
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
  using C = Cfg<D>;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kDkdvSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  launch_delta<float, D>(a);
  const dim3 grid(a.batch * a.heads, (a.seq_len + kTile - 1) / kTile);
  dkdv_kernel<D><<<grid, kThreads, C::kDkdvSmem, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.qs,
      a.ks, a.vs, a.dos, a.seq_len, a.heads, a.scale, a.causal);
  dq_kernel<D><<<grid, kThreads, C::kDqSmem, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<float*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.seq_len,
      a.heads, a.scale, a.causal);
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
  dkdv_wgmma_kernel<D><<<dim3(B * H, (T + C::kBK - 1) / C::kBK), kSm90Threads, C::kDkdvSmem,
                         a.stream>>>(q_kv_map, k_map, v_map, do_kv_map, lse, delta,
                                     static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), T, H,
                                     a.scale, a.causal);
  dq_wgmma_kernel<D><<<dim3(B * H, (T + C::kBQ - 1) / C::kBQ), kSm90Threads, C::kDqSmem,
                       a.stream>>>(q_map, k_map, v_map, do_map, lse, delta,
                                   static_cast<bf16*>(a.dq), T, H, a.scale, a.causal);
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
