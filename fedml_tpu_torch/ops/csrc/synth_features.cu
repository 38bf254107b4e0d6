// Per-client keyed synthetic features, CUDA C++ for Hopper (sm_90a).
//
// Replaces XLA-generated code of the JAX package, not a Pallas kernel:
// `_gen_per_client_impl` behind
// `synthetic_classification_device_per_client`
// (fedml_tpu/data/synthetic.py:150-225), which draws each row of a
// registry cohort group's features as means[y] + sigma * noise, the
// noise keyed by (client seed, sample index) so that a client's
// features do not depend on its slot, its group's shape or its cohort.
//
// The port keys its own stream (the bits are not jax's threefry):
// element d of sample s of client c is
//   Philox4x32-10(key = (seed[c], 0), counter = (s, d / 4, 0, 0))
// -> 4 words -> two Box-Muller pairs -> 4 normals, of which word pair
// (0, 1) gives dims 4j, 4j + 1 and pair (2, 3) dims 4j + 2, 4j + 3:
//   u = ((a >> 8) + 1) * 2^-24 in (0, 1], v = (b >> 8) * 2^-24 in [0, 1),
//   r = sqrt(-2 ln u), n = (r cos 2 pi v, r sin 2 pi v).
// Every float operation is written rounded on its own (no FMA), as the
// plain PyTorch version computes it op by op.
//
// One launch writes a group's [C, S, dim] features. The work is bound by
// the bytes written on an H100 (3.35 TB/s): each thread makes 4 outputs
// from one Philox block (10 rounds of two 32-bit multiplies) and stores
// them as one 16-byte (f32) or 8-byte (bf16) store where the row allows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& n0, float& n1) {
  const float u = __fmul_rn((float)((a >> 8) + 1u), 5.9604644775390625e-08f);  // 2^-24
  const float v = __fmul_rn((float)(b >> 8), 5.9604644775390625e-08f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u)));
  const float theta = __fmul_rn(6.28318530717958647692f, v);
  n0 = __fmul_rn(r, cosf(theta));
  n1 = __fmul_rn(r, sinf(theta));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&a);
  r.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = r;
}

// y [C, S] int64 labels, means [classes, dim] f32, seeds [C] uint32,
// out [C, S, dim] of T. VEC: dim % 4 == 0 and out aligned for a 4-wide
// store.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    synth_kernel(const long long* __restrict__ y, const float* __restrict__ means,
                 const uint32_t* __restrict__ seeds, float sigma, T* __restrict__ out, int c,
                 long long s, int dim) {
  const int blocks4 = (dim + 3) / 4;
  const long long items = (long long)c * s * blocks4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < items; q += stride) {
    const int j = (int)(q % blocks4);
    const long long cs = q / blocks4;
    const int ci = (int)(cs / s);
    const uint32_t si = (uint32_t)(cs - (long long)ci * s);
    const uint4 w = philox4x32_10(make_uint4(si, (uint32_t)j, 0u, 0u), __ldg(seeds + ci), 0u);
    float v[4];
    box_muller(w.x, w.y, v[0], v[1]);
    box_muller(w.z, w.w, v[2], v[3]);
    const float* m = means + __ldg(y + cs) * dim + 4 * j;
    T* o = out + cs * dim + 4 * j;
    if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __fadd_rn(__ldg(m + k), __fmul_rn(sigma, v[k]));
      store4(o, v);
    } else {
      for (int k = 0; k < 4 && 4 * j + k < dim; ++k)
        store(o + k, __fadd_rn(__ldg(m + k), __fmul_rn(sigma, v[k])));
    }
  }
}

// the raw Philox words of every (client, sample, block of 4 dims)
__global__ void __launch_bounds__(kThreads)
    words_kernel(const uint32_t* __restrict__ seeds, uint4* __restrict__ out, int c, long long s,
                 int blocks4) {
  const long long items = (long long)c * s * blocks4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < items; q += stride) {
    const int j = (int)(q % blocks4);
    const long long cs = q / blocks4;
    const int ci = (int)(cs / s);
    const uint32_t si = (uint32_t)(cs - (long long)ci * s);
    out[q] = philox4x32_10(make_uint4(si, (uint32_t)j, 0u, 0u), __ldg(seeds + ci), 0u);
  }
}

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <typename T>
int launch(const void* y, const void* means, const void* seeds, float sigma, void* out, int c,
           long long s, int dim, cudaStream_t st) {
  const long long items = (long long)c * s * ((dim + 3) / 4);
  const size_t align = 4 * sizeof(T);
  const bool vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(out) % align == 0;
  const auto* yy = static_cast<const long long*>(y);
  const auto* mm = static_cast<const float*>(means);
  const auto* ss = static_cast<const uint32_t*>(seeds);
  if (vec) {
    synth_kernel<T, true><<<blocks_for(items), kThreads, 0, st>>>(yy, mm, ss, sigma,
                                                                   static_cast<T*>(out), c, s, dim);
  } else {
    synth_kernel<T, false><<<blocks_for(items), kThreads, 0, st>>>(yy, mm, ss, sigma,
                                                                    static_cast<T*>(out), c, s, dim);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y [c, s] int64, means [classes, dim] float32, seeds [c] uint32, out
// [c, s, dim] of dtype (0 = float32, 1 = bfloat16), all contiguous.
// Returns 0, a CUDA error code, or -1 for a dtype it does not take.
int synth_features(const void* y, const void* means, const void* seeds, float sigma, void* out,
                   int c, long long s, int dim, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(y, means, seeds, sigma, out, c, s, dim, st);
  if (dtype == 1) return launch<__nv_bfloat16>(y, means, seeds, sigma, out, c, s, dim, st);
  return -1;
}

// out [c, s, blocks4, 4] uint32: the Philox words synth_features draws.
int synth_philox_words(const void* seeds, void* out, int c, long long s, int blocks4,
                       void* stream) {
  const long long items = (long long)c * s * blocks4;
  words_kernel<<<blocks_for(items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(seeds), static_cast<uint4*>(out), c, s, blocks4);
  return (int)cudaGetLastError();
}

const char* synth_features_error_string(int code) {
  if (code == -1) return "dtype not taken (float32 or bfloat16)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
