// Fused RMSNorm for Hopper (sm_90a), in CUDA C++.
//
// Replaces the TPU kernel of src/repro/kernels/rmsnorm.py (rmsnorm, its
// _rmsnorm_kernel): per row of a (rows, d) view,
//   o = x * rsqrt(mean(x*x) + eps) * gamma
// with the statistics in f32 and o stored in x's dtype T (float or
// __nv_bfloat16; gamma may be either, independently).
//
// What bounds it on an H100: device memory. Each element is read once and
// written once (8 B in f32, 4 B in bf16, plus gamma once), against about
// four flops an element, three orders of magnitude below the card's rate.
// At the Mamba2 step's shapes (512 rows of 1536 or 3072 in bf16: 1.5 or
// 3 MB) the launch itself, a few microseconds, is larger than the bound.
//
// What the design does about it:
// * One warp per row, several rows a block: a row is read with coalesced
//   loads, its sum of squares is a five-step __shfl_xor_sync reduction in
//   registers, and no shared memory or second kernel is needed.
// * 16-byte vector loads and stores (4 f32 or 8 bf16 an access) when d and
//   the base pointers allow it; otherwise one element an access. Either way
//   the loop bound masks the ragged tail, so any d and any row count run
//   without a padded copy (the TPU kernel pads rows to its tile).
// * The row is read twice, once for the sum and once to scale it; the
//   second read of a warp's own row (at most a few KB) comes from L1/L2.
// * The products are spelled __fmul_rn so that nvcc contracts nothing into
//   an FMA, in the plain version's order: (x * inv) * gamma.
// * Offsets are int64.
// A simple kernel that is right first: keeping the row in registers for
// the second pass is left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // warps (rows) of a block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements of T in one 16-byte access (VEC == 1: one element)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, typename G, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                               T* __restrict__ out, int64_t rows, int64_t d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int64_t nvec = d / VEC;  // d % VEC == 0 whenever VEC > 1

  float ss = 0.f;
  for (int64_t i = lane; i < nvec; i += 32) {
    const Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(xr)[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = to_f32(p.v[k]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));

  for (int64_t i = lane; i < nvec; i += 32) {
    const Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(xr)[i];
    const Pack<G, VEC> g = reinterpret_cast<const Pack<G, VEC>*>(gamma)[i];
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o.v[k] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(p.v[k]), inv), to_f32(g.v[k])));
    reinterpret_cast<Pack<T, VEC>*>(orow)[i] = o;
  }
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gamma, void* out, int64_t rows, int64_t d,
                   float eps, int vec, cudaStream_t stream) {
  const int64_t blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(gamma);
  T* op = static_cast<T*>(out);
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    rmsnorm_kernel<T, G, V><<<(unsigned)blocks, ROWS_PER_BLOCK * 32, 0, stream>>>(xp, gp, op,
                                                                                 rows, d, eps);
  } else {
    rmsnorm_kernel<T, G, 1><<<(unsigned)blocks, ROWS_PER_BLOCK * 32, 0, stream>>>(xp, gp, op,
                                                                                 rows, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype, gamma_dtype: 0 float32, 1 bfloat16. x and out are dense (rows, d);
// gamma is dense (d,). vec != 0 takes 16-byte accesses: the caller sets it
// only when d is a multiple of 16 / sizeof(x's type) and of gamma's, and x,
// gamma and out are 16-byte aligned. Returns a cudaError_t (0 on success);
// launches nothing for an empty input.
extern "C" int rmsnorm(int dtype, int gamma_dtype, int64_t rows, int64_t d, float eps,
                       const void* x, const void* gamma, void* out, int vec, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gamma_dtype == 0)
    return (int)launch<float, float>(x, gamma, out, rows, d, eps, vec, st);
  if (dtype == 0 && gamma_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, gamma, out, rows, d, eps, vec, st);
  if (dtype == 1 && gamma_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, gamma, out, rows, d, eps, vec, st);
  if (dtype == 1 && gamma_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, out, rows, d, eps, vec, st);
  return (int)cudaErrorInvalidValue;
}
