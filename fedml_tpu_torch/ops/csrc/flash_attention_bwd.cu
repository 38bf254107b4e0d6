// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the JAX package's `_bwd` (fedml_tpu/ops/flash_attention.py:140-175),
// the custom_vjp backward of the Pallas `_flash_kernel`: a FlashAttention-2
// recompute from the forward's saved per-row log-sum-exp, never the dense
// [T, T] matrix. Same function, over [B, T, H, D] inputs (f32 or bf16, D in
// {16, 32, 64, 128}, causal or not, any T):
//   delta = rowsum(dO * O)
//   P     = exp(scale * Q K^T - lse), masked entries exactly 0 (the
//           reference masks S with -1e30 before the exp)
//   dV = P^T dO,  dS = P * (dO V^T - delta) * scale,  dK = dS^T Q,  dQ = dS K
// Arithmetic and accumulation are f32, as `_bwd` does them; dQ, dK and dV
// are written in the input dtype, contiguous [B, T, H, D].
//
// Bound on an H100: at the training shape ([32, 4096, 8, 64] bf16, causal)
// the five products do ~10*D flops per unmasked (query, key) pair against
// ~8 passes over [B, T, H, D] of bytes, so operations bound it, far above
// the card's balance point.
//
// Design: right and simple first (speed is a later change's). Three
// kernels on the caller's stream, none with floating-point atomics, so
// every output element is summed in one fixed order and two runs agree
// bitwise:
//   1. `delta_kernel`: one warp per (b, t, h) row, a shuffle-tree sum.
//   2. `dkdv_kernel`: one block per (64-key tile, b*h). K and V stay in
//      shared memory; the block walks the 64-query tiles from the causal
//      start, recomputes S and dP there, writes P and dS to shared memory
//      and adds P^T dO and dS^T Q into dK and dV held in registers.
//   3. `dq_kernel`: one block per (64-query tile, b*h), walking the key
//      tiles up to the causal end: S and dP again, then dQ += dS K.
// It recomputes S and dP twice (7 products for 5); that is the price of
// having no atomics and no [T, T] scratch.
//
// Every product runs on the tensor cores as mma.sync m16n8k8 TF32 with f32
// accumulation, operands read from shared memory tiles that hold every
// input converted to f32. bf16 inputs are exact in TF32, so Q K^T and
// dO V^T are one pass; P and dS are f32 and are split into TF32 hi + lo
// (x = hi + lo to ~2^-22), so the products with them are two passes. f32
// inputs take 3xTF32 everywhere (lo*hi + hi*lo + hi*hi), which keeps f32's
// accuracy where one TF32 pass would not. Nothing is rounded to bf16
// before the outputs.
//
// Shared-memory rows are padded (Q, K, V, dO by 4 floats; P and dS by 8 in
// the dK/dV kernel, where they are read transposed; dS by 4 in the dQ
// kernel), so each fragment load of a warp touches 32 distinct banks where
// the access is row-major and at most 2 lanes share a bank where it is
// transposed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;  // queries and keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Strides {
  long long b, t, h;  // element strides of batch, time and head; D is unit-stride
};

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

// ---- arithmetic --------------------------------------------------------------

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

// An operand fragment read from an f32 tile: its TF32 hi part and, where
// the value is not exact in TF32, its lo part.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <bool kSplit, int N>
__device__ __forceinline__ void make_frag(Frag<N>& f, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (kSplit) split(x[i], f.hi[i], f.lo[i]);
    else f.hi[i] = __float_as_uint(x[i]);  // exact in TF32 (a bf16 value)
  }
}

// d += a * b, the small terms first. kSplitA / kSplitB: that operand is
// not exact in TF32, so its lo part takes a pass of its own (both: 3xTF32).
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_x(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  if constexpr (kSplitA) mma(d, a.lo, b.hi[0], b.hi[1]);
  if constexpr (kSplitB) mma(d, a.hi, b.lo[0], b.lo[1]);
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

// 16 bytes of the input as f32: 4 floats or 8 bf16 values
__device__ __forceinline__ void unpack(const uint4& raw, const float*, float* out) {
  *reinterpret_cast<float4*>(out) = make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                                                __uint_as_float(raw.z), __uint_as_float(raw.w));
}
__device__ __forceinline__ void unpack(const uint4& raw, const __nv_bfloat16*, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(out + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// ---- tiles -------------------------------------------------------------------

// Rows t0 .. t0+63 of (b, h) of a [B, T, H, D] input into an f32 tile of
// row stride kLd; rows at or past seq_len are zero. The wrapper guarantees
// a 16-byte-aligned base and 16-byte-multiple strides.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, Strides s,
                                          int b, int h, int t0, int seq_len) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = D / kVec;
  const T* base = src + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float* out = dst + r * Cfg<D>::kLd + c;
    const int t = t0 + r;
    if (t < seq_len) {
      unpack(*reinterpret_cast<const uint4*>(base + t * s.t + c), base, out);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(out + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
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
template <bool kSplit, int D>
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
    make_frag<kSplit>(aq, xq);
    make_frag<kSplit>(ado, xdo);
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
      make_frag<kSplit>(bk, xk);
      make_frag<kSplit>(bv, xv);
      mma_x<kSplit, kSplit>(p[n], aq, bk);   // S
      mma_x<kSplit, kSplit>(ds[n], ado, bv); // dP
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

// ---- kernels -----------------------------------------------------------------

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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            Strides qs, Strides ks, Strides vs, Strides dos, int seq_len, int heads,
            float scale, int causal) {
  using C = Cfg<D>;
  constexpr bool kSplit = std::is_same<T, float>::value;
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
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int n_qt = (seq_len + kTile - 1) / kTile;
  const int qt0 = causal ? blockIdx.x : 0;  // earlier query tiles see none of these keys

  load_tile<T, D>(k_s, k, ks, b, h, k0, seq_len);
  load_tile<T, D>(v_s, v, vs, b, h, k0, seq_len);

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
    load_tile<T, D>(q_s, q, qs, b, h, q0, seq_len);
    load_tile<T, D>(do_s, dout, dos, b, h, q0, seq_len);
    load_rows(lse_s, delta_s, lse, delta, bh, q0, seq_len);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<kSplit, D>(q_s, k_s, do_s, v_s, lse_s, delta_s, qa0, kc0, q0, k0, seq_len, causal,
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
      make_frag<true>(ap, xp);
      make_frag<true>(ads, xds);
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
        make_frag<kSplit>(bdo, xdo);
        make_frag<kSplit>(bq, xq);
        mma_x<true, kSplit>(acc_dv[n], ap, bdo);
        mma_x<true, kSplit>(acc_dk[n], ads, bq);
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks,
          Strides vs, Strides dos, int seq_len, int heads, float scale, int causal) {
  using C = Cfg<D>;
  constexpr bool kSplit = std::is_same<T, float>::value;
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
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int q0 = qt * kTile;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int n_kt = causal ? qt + 1 : (seq_len + kTile - 1) / kTile;

  load_tile<T, D>(q_s, q, qs, b, h, q0, seq_len);
  load_tile<T, D>(do_s, dout, dos, b, h, q0, seq_len);
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
    load_tile<T, D>(k_s, k, ks, b, h, k0, seq_len);
    load_tile<T, D>(v_s, v, vs, b, h, k0, seq_len);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<kSplit, D>(q_s, k_s, do_s, v_s, lse_s, delta_s, qa0, kc0, q0, k0, seq_len, causal,
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
      make_frag<true>(ads, xds);
#pragma unroll
      for (int n = 0; n < C::kNt; ++n) {
        float xk[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) xk[j] = k_s[(kk * 8 + t + j * 4) * C::kLd + dc0 + n * 8 + g];
        Frag<2> bk;
        make_frag<kSplit>(bk, xk);
        mma_x<true, kSplit>(acc[n], ads, bk);
      }
    }
    __syncthreads();  // the next tile overwrites K, V and dS
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + qa0 + g + 8 * j;
    if (row >= seq_len) continue;
    T* out = dq + (((long long)b * seq_len + row) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < C::kNt; ++n) {
      const int col = dc0 + n * 8 + 2 * t;
      store2(out + col, acc[n][2 * j], acc[n][2 * j + 1]);
    }
  }
}

// ---- host side ---------------------------------------------------------------

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
int launch(const Args& a) {
  using C = Cfg<D>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kDkdvSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kDqSmem);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)a.batch * a.seq_len * a.heads;
  delta_kernel<T, D><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), dout, delta, a.os, a.dos, a.batch, a.seq_len, a.heads);
  const dim3 grid((a.seq_len + kTile - 1) / kTile, a.batch * a.heads);
  dkdv_kernel<T, D><<<grid, kThreads, C::kDkdvSmem, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks,
      a.vs, a.dos, a.seq_len, a.heads, a.scale, a.causal);
  dq_kernel<T, D><<<grid, kThreads, C::kDqSmem, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.seq_len,
      a.heads, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o and dout are [B, T, H, D]
// views (unit-stride D) whose base and strides of dimensions longer than 1
// are 16-byte multiples; lse and delta are contiguous f32 [B, H, T] (delta
// is scratch, written here); dq, dk, dv are contiguous [B, T, H, D] in the
// input dtype. Returns 0 on success, else the CUDA error code of the
// launches; the caller raises on anything but 0.
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
  if (dtype == 0) return dispatch_dim<float>(head_dim, a);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
