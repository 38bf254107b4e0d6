// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, TMA loads through 4-D tensor maps over [B, T, H, D] views,
// and bf16 and tf32 `wgmma` with its shared-memory matrix descriptors.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <type_traits>

namespace hopper {

// A barrier wait that spins this many clocks (~9 s) means a lost
// arrival: trap, so a bug fails the launch instead of hanging the card.
constexpr long long kSpinClocks = 1ll << 34;

struct Strides {
  long long b, t, h;  // element strides of batch, time and head; D is unit-stride
};

// ---- mbarriers and TMA --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long start = 0;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > kSpinClocks) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of element (row, col) in a tile that TMA stored as boxes
// of kChunk columns, each kRows rows of kRowBytes, with the swizzle that
// XORs the 16-byte unit with bits 7.. of the offset (CU_TENSOR_MAP_
// SWIZZLE_32B/64B/128B for 32/64/128-byte rows). Boxes start
// 1024-aligned, so the XOR depends only on row & 7.
template <typename T, int kChunk, int kRows>
__device__ __forceinline__ int tile_off(int row, int col) {
  constexpr int kRowBytes = kChunk * (int)sizeof(T);
  const int swz = ((((row & 7) * kRowBytes) >> 7) & (kRowBytes / 16 - 1)) << 4;
  return (col / kChunk) * (kRows * kRowBytes) + row * kRowBytes +
         (((col % kChunk) * (int)sizeof(T)) ^ swz);
}

// ---- block order ------------------------------------------------------------------

// Heads whose tiles are in flight together (block_work): 16 heads' K and
// V at T 4096, D 64 in bf16 take 16 MB of the 50 MB L2.
constexpr int kHeadGroup = 16;

// Grid y's limit: tiles past it fold into grid x (work_grid).
constexpr int kGridY = 65535;

// The launch grid of n_bh (batch*head) rows of n_tiles tiles each: batch*
// head on x and tiles on y while they fit y's 65,535; beyond that the
// tiles fold into x, fold = ceil(n_tiles / 65535) copies of the rows, so
// T past 65,535 tiles of 64 still launches. The Python wrapper's
// `tile_grid` (ops/flash_attention.py) is the same arithmetic, which a CPU
// test checks and which refuses a grid x past 2^31 - 1.
inline dim3 work_grid(int n_bh, int n_tiles) {
  const int fold = (n_tiles + kGridY - 1) / kGridY;
  return dim3((unsigned)((long long)n_bh * fold), (unsigned)((n_tiles + fold - 1) / fold));
}

// The (batch*head, tile rank) this block works on, for a work_grid of
// n_bh rows of n_tiles tiles; false for the blocks past the work that a
// folded grid's last row leaves over (they return at once). Blocks start
// in launch order, x fastest, and the block's linear index alone picks its
// work, so a folded grid hands out the same work in the same order; they
// are handed out in groups of kHeadGroup heads and, within a group, rank
// by rank (rank 0 = each head's longest causal walk) across the group's
// heads. So the longest walks start first, and the blocks in flight at
// once stream the tiles of a few heads, which stay in L2, not one tile of
// every head.
__device__ __forceinline__ bool block_work(int n_bh, int n_tiles, int& bh, int& rank) {
  const long long lin = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (lin >= (long long)n_bh * n_tiles) return false;
  const long long g0 = lin / ((long long)kHeadGroup * n_tiles) * kHeadGroup;  // first head
  const long long size = min((long long)kHeadGroup, (long long)n_bh - g0);
  const long long r = lin - g0 * n_tiles;
  rank = (int)(r / size);
  bh = (int)(g0 + r % size);
  return true;
}

// 2^x; flushes results below 2^-126 to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// ---- wgmma ----------------------------------------------------------------------

// The shared-memory matrix descriptor of a tile stored by TMA with the
// swizzle of its `row_bytes` (128, 64 or 32). K-major (the reduction
// runs along the row): `lbo` is unused and `sbo` is the step between
// 8-row groups. MN-major (the row is the output's dimension): `sbo` is
// the step between 8-row groups along the reduction, `lbo` the step
// between the boxes that hold successive row-widths of columns.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int row_bytes, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) | (uint64_t)((lbo >> 4) & 0x3fff) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fff) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the points where this is called.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// d (+)= A B on one m64nNk16 step, bf16 operands, f32 accumulators. The
// accumulator of thread (warp w, lane 4g + t) holds rows 16w + g (+8)
// and columns 8j + 2t (+1): d[4j], d[4j+1] on row 16w + g and d[4j+2],
// d[4j+3] on row 16w + g + 8. wgmma_ss reads A and B from shared memory
// by descriptor (A K-major; `accumulate` 0 overwrites d). wgmma_rs takes
// A from registers, four bf16 pairs of this thread's rows: (16w + g,
// k 2t..2t+1), (16w + g + 8, the same), (16w + g, k 2t+8..2t+9), (16w +
// g + 8, the same) -- the accumulator's own layout, so the accumulators
// of k columns 16kk .. 16kk+15 packed pairwise in order are the A operand
// of k-step kk. kTransB = 1: B is MN-major.

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32. Adding half a TF32 ulp to the
// magnitude bits and clearing the low 13 is two integer instructions;
// cvt.rna compiles to four (it also guards Inf and NaN, which reach the
// output as NaN through x - hi here all the same).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 relative, both exact TF32 values: the split
// that 3xTF32 (lo*hi + hi*lo + hi*hi) is built on, in both flash routes
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d (+)= A B on one m64nNk8 step, TF32 operands (f32 bit patterns whose
// low 13 bits are zero), f32 accumulators: the same accumulator layout as
// the bf16 forms above. tf32 has no transpose bits, so A (from shared
// memory) and B are K-major. wgmma_tf32_rs takes A from registers, one
// element each: (16w + g, k t), (16w + g + 8, k t), (16w + g, k t + 4),
// (16w + g + 8, k t + 4), which is not the accumulator's order (columns
// 2t, 2t + 1); a caller that feeds accumulators back as A stores B's k
// rows in the matching order instead (see kpos in flash_attention_bwd.cu).

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3},"
      " %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Orders this thread's generic-proxy writes (and reads) of shared memory
// before later async-proxy accesses (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- bf16 tiles for wgmma -------------------------------------------------------

// A [rows, D] bf16 tile as TMA stores it: boxes of kChunk columns (rows
// of at most 128 bytes), each swizzled by its row bytes.
template <int D>
struct Bf16Tile {
  static constexpr int kChunk = D > 64 ? 64 : D;
  static constexpr int kRowBytes = kChunk * 2;
};

// Byte offset of k-step `ks` (16 columns) in a [kRows, D] tile read
// K-major, and of k-step `kk` (rows 16kk .. 16kk+15) in one read MN-major
template <int D, int kRows>
__host__ __device__ constexpr int kmajor_step(int ks) {
  return (ks * 16 / Bf16Tile<D>::kChunk) * kRows * Bf16Tile<D>::kRowBytes +
         (ks * 16 % Bf16Tile<D>::kChunk) * 2;
}
template <int D>
__host__ __device__ constexpr int mnmajor_step(int kk) {
  return kk * 16 * Bf16Tile<D>::kRowBytes;
}

// Descriptor of k-step `ks` of a [kRows, D] tile read K-major: the
// reduction runs along D.
template <int D, int kRows>
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int ks) {
  using C = Bf16Tile<D>;
  return smem_desc(tile + kmajor_step<D, kRows>(ks), C::kRowBytes, 16, 8 * C::kRowBytes);
}

// Descriptor of k-step `kk` of a [kRows, D] tile read MN-major: the
// reduction runs along the rows, D is the output's columns.
template <int D, int kRows>
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, int kk) {
  using C = Bf16Tile<D>;
  return smem_desc(tile + mnmajor_step<D>(kk), C::kRowBytes, kRows * C::kRowBytes,
                   8 * C::kRowBytes);
}

// A descriptor moved by `bytes` (a multiple of 16) within shared memory:
// the start address is its low 14 bits, in 16-byte units, and shared
// memory ends below 2^18 bytes, so the sum never carries out of them
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, int bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// (x, y) = hi + lo as bf16 pairs, x in the low half: hi = bf16(x)
// rounded to nearest even (one conversion for the pair), lo = bf16(x - hi)
// rounded to nearest, ties away from zero, by integer ops (x - hi is exact
// in f32): the conversion unit (16 results a clock per SM) is the
// kernels' scarcest pipe after the exponentials
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float rx = x - __uint_as_float(hi << 16), ry = y - __uint_as_float(hi & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(rx) + 0x8000u, __float_as_uint(ry) + 0x8000u, 0x7632);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Block-start set-up of the wgmma kernels: one barrier for the resident
// tiles and one `full` barrier per ring stage, which completes on the TMA
// bytes and kStageArrivals arrivals (thread 0's expect_tx, plus any the
// kernel adds, as the backward's four warps after they have stored a
// tile's lse and delta).
template <int kStages, int kStageArrivals>
__device__ __forceinline__ void init_barriers(const unsigned char* smem, uint64_t* bars) {
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzle assumes 1024-byte boxes
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[1 + s], kStageArrivals);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Thread 0: rows `row` .. `row` + kRows - 1 of (b, h) of a_map into `dst`
// by TMA on barrier `bar`, whose expected bytes the caller has set
template <int D, int kRows>
__device__ __forceinline__ void tma_tile(const CUtensorMap* map, unsigned char* dst,
                                          uint64_t* bar, int b, int h, int row) {
  using C = Bf16Tile<D>;
#pragma unroll
  for (int c = 0; c < D / C::kChunk; ++c)
    tma_load(dst + c * kRows * C::kRowBytes, map, bar, c * C::kChunk, h, row, b);
}

// Thread 0: the same rows of a_map and of b_map, one after the other from
// `dst`, on barrier `bar`
template <int D, int kRows>
__device__ __forceinline__ void load_pair(const CUtensorMap* a_map, const CUtensorMap* b_map,
                                          unsigned char* dst, uint64_t* bar, int b, int h,
                                          int row) {
  constexpr int kBytes = kRows * D * 2;
  mbar_expect_tx(bar, 2 * kBytes);
  tma_tile<D, kRows>(a_map, dst, bar, b, h, row);
  tma_tile<D, kRows>(b_map, dst + kBytes, bar, b, h, row);
}

// ---- tensor maps (host) -------------------------------------------------------

// error codes beside cudaError_t's (which are >= 0)
constexpr int kErrNoEncoder = -1;  // libcuda has no cuTensorMapEncodeTiled (before CUDA 12)
constexpr int kErrEncode = -1000;  // minus the CUresult of a failed encode

using EncodeFn = decltype(&cuTensorMapEncodeTiled);

inline EncodeFn tensor_map_encoder() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over [B, T, H, D] (innermost first: D, H, T, B) whose box is
// `rows` time steps of one (batch, head) and `chunk` columns, swizzled by
// the box's row bytes. Rows past T arrive as zeros.
template <typename T>
int encode(CUtensorMap* map, const void* base, int batch, int seq_len, int heads, int head_dim,
           Strides st, int chunk, int rows) {
  EncodeFn fn = tensor_map_encoder();
  if (fn == nullptr) return kErrNoEncoder;
  constexpr long long es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)heads, (cuuint64_t)seq_len,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(st.h * es), (cuuint64_t)(st.t * es),
                                 (cuuint64_t)(st.b * es)};
  const cuuint32_t box[4] = {(cuuint32_t)chunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const int row_bytes = chunk * (int)es;
  const CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(
      map, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode - (int)r;
}

// The message of a launch's return code: a cudaError_t or one of the
// codes above.
inline const char* error_string(int code) {
  if (code == kErrNoEncoder) return "libcuda has no cuTensorMapEncodeTiled (CUDA 12 or later needed)";
  if (code <= kErrEncode) {
    static thread_local char msg[80];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d", kErrEncode - code);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
