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
// At the Mamba2 step's shapes (512 rows of 1536 or 3072 in bf16: 1.5 or 3
// MB) the bound is 1-2 us, so what counts there is latency: how many bytes
// are in flight. By Little's law 3.35 TB/s x ~1 us is ~25 KB an SM.
//
// What the design does about it:
// * One pass: the row is read once into registers, with all of a lane's
//   16-byte loads issued before the first add, and the output is written
//   from the same registers. A lane holds NV vectors (a compile-time
//   constant, NV in {1, 2, 4, 6, 8, 12, 16}: 1536, 3072 and 4096 bf16 and
//   1024 f32 are 6, 12, 16 and 8 a lane of one warp, exactly) as raw
//   32-bit words; an empty asm between the two uses keeps nvcc from
//   holding their f32 values live across the sum instead (twice the
//   registers for bf16, which spilled at NV = 12 and 16). A row of up to
//   512 vectors is one warp's; a wider one is shared by up to 16 warps of
//   a block, whose partial sums add through shared memory in warp order.
//   Rows wider than 16 warps x 16 vectors (64K bf16, 32K f32 elements),
//   and rows whose accesses are one element each, take a two-pass loop
//   kernel (one block a row, the second read from L2).
// * The grid is sized to the card: one warp a row where it fits, and as
//   many rows a block (up to 8) as leave at least 3/4 of the SMs a block;
//   at 512 rows of 3072 bf16 that is 128 blocks of 4 rows, all of the 3 MB
//   in flight at once (12 loads of 16 B a lane, ~24 KB an SM). Fewer,
//   larger blocks read gamma fewer times.
// * gamma is read once a block: into shared memory (as f32) while the
//   rows' loads are in flight when a block holds several rows, straight
//   from memory when a block is one row.
// * 16-byte vector loads and stores (4 f32 or 8 bf16 an access) when d and
//   the base pointers allow it; otherwise one element an access (the
//   two-pass kernel). Either way the ragged tail is masked, so any d and
//   any row count run without a padded copy (the TPU kernel pads rows to
//   its tile).
// * The sums add in a fixed order (a lane's vectors in turn, a butterfly of
//   shuffles, then the warps in order), so two calls give the same bits.
//   The products are spelled __fmul_rn so that nvcc contracts nothing into
//   an FMA, in the plain version's order: (x * inv) * gamma.
// * Offsets are int64.
// What holds it back (PERF.md): at 512 rows the time is mostly the launch
// and one round trip to memory (a 4 x 64 call takes ~5.5 us on the card);
// at 16384 x 4096 it reaches ~82% of its bound. Left for later work: TMA
// bulk copies of whole rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NV = 16;       // vectors a lane holds
constexpr int MAX_WARPS = 16;    // warps sharing a row
constexpr int MAX_ROWS = 8;      // rows (warps) of a block of one-warp rows
constexpr int WIDE_THREADS = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements of T in one access (the two-pass kernel; VEC == 1: one
// element)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A 16-byte vector held as four 32-bit words: element e as f32, and the
// words of 16 / sizeof(T) f32 values rounded to T
__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
template <typename T> __device__ __forceinline__ float elem(const uint4& w, int e);
template <> __device__ __forceinline__ float elem<float>(const uint4& w, int e) {
  return __uint_as_float(word(w, e));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& w, int e) {
  const uint32_t u = word(w, e >> 1);
  return __uint_as_float(e & 1 ? u & 0xffff0000u : u << 16);
}
template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// the row's sum of squares from each warp's partial, in warp order
// (nw warps a row, one row a block when nw > 1)
__device__ __forceinline__ float row_sum(float ss, int nw, float* red) {
  if (nw == 1) return ss;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = ss;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// Block of rpb rows of wpr warps each (rpb == 1 when wpr > 1), 16-byte
// vectors (d a multiple of VEC = 16 / sizeof(T), operands aligned). Lane l
// of a row's wpr * 32 holds vectors l, l + wpr * 32, ... (NV of them) as
// raw words: only the words stay live between the two uses of the row.
template <typename T, typename G, int NV>
__global__ void __launch_bounds__(MAX_WARPS * 32) rmsnorm_kernel(const T* __restrict__ x,
                                                                 const G* __restrict__ gamma,
                                                                 T* __restrict__ out,
                                                                 int64_t rows, int64_t d,
                                                                 float eps, int wpr, int rpb) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float4 s_gamma4[];  // d floats when rpb > 1
  __shared__ float red[MAX_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * rpb + warp / wpr;
  const int li = (warp % wpr) * 32 + lane, stride = wpr * 32;
  const int64_t nvec = d / VEC;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * d);

  uint4 v[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {  // every load issued before the first add
    const int64_t i = li + (int64_t)k * stride;
    v[k] = live && i < nvec ? xr[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  if (rpb > 1) {  // gamma once a block, while the rows' loads fly
    const Pack<G, VEC>* gp = reinterpret_cast<const Pack<G, VEC>*>(gamma);
    for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
      const Pack<G, VEC> g = gp[i];
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        s_gamma4[i * (VEC / 4) + q] = make_float4(to_f32(g.v[4 * q]), to_f32(g.v[4 * q + 1]),
                                                  to_f32(g.v[4 * q + 2]), to_f32(g.v[4 * q + 3]));
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = elem<T>(v[k], e);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  ss = row_sum(warp_sum(ss), wpr, red);
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
  if (rpb > 1) __syncthreads();  // s_gamma is filled
  if (!live) return;

  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int64_t i = li + (int64_t)k * stride;
    if (i >= nvec) break;
    // opaque to the compiler: the f32 values of the first pass are not
    // kept live across the sum (NV x VEC registers), they are made again
    uint4 w = v[k];
    asm volatile("" : "+r"(w.x), "+r"(w.y), "+r"(w.z), "+r"(w.w));
    float gv[VEC], o[VEC];
    if (rpb > 1) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 g4 = s_gamma4[i * (VEC / 4) + q];
        gv[4 * q] = g4.x;
        gv[4 * q + 1] = g4.y;
        gv[4 * q + 2] = g4.z;
        gv[4 * q + 3] = g4.w;
      }
    } else {
      const Pack<G, VEC> g = reinterpret_cast<const Pack<G, VEC>*>(gamma)[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) gv[e] = to_f32(g.v[e]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(__fmul_rn(elem<T>(w, e), inv), gv[e]);
    orow[i] = pack<T>(o);
  }
}

// Rows too wide for the register kernel, and every row whose accesses are
// one element each: one block a row (threads a multiple of 32, at most
// 1024), two passes (the second read comes from L2)
template <typename T, typename G, int VEC>
__global__ void __launch_bounds__(WIDE_THREADS) rmsnorm_wide_kernel(
    const T* __restrict__ x, const G* __restrict__ gamma, T* __restrict__ out, int64_t d,
    float eps) {
  __shared__ float red[WIDE_THREADS / 32];
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* orow = out + (int64_t)blockIdx.x * d;
  const int64_t nvec = d / VEC;
  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    const Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(xr)[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32(p.v[e]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
  ss = row_sum(warp_sum(ss), blockDim.x / 32, red);
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    const Pack<T, VEC> p = reinterpret_cast<const Pack<T, VEC>*>(xr)[i];
    const Pack<G, VEC> g = reinterpret_cast<const Pack<G, VEC>*>(gamma)[i];
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(p.v[e]), inv), to_f32(g.v[e])));
    reinterpret_cast<Pack<T, VEC>*>(orow)[i] = o;
  }
}

// How a call runs: the register kernel's vectors a lane (nv), warps a row
// (wpr) and rows a block (rpb), or the two-pass kernel (nv == 0, one block
// a row).
struct Plan {
  int nv, wpr, rpb;
  int64_t blocks;
  int threads;
  size_t smem;
};

constexpr int NVS[] = {1, 2, 4, 6, 8, 12, 16};

Plan plan(int64_t rows, int64_t d, int vec, int itemsize, int sms) {
  const int64_t nvec = vec ? d / (16 / itemsize) : d;
  Plan p{0, 1, 1, rows, 0, 0};
  if (!vec || nvec > (int64_t)MAX_WARPS * 32 * MAX_NV) {
    p.threads = (int)(nvec < WIDE_THREADS ? (nvec + 31) / 32 * 32 : WIDE_THREADS);
    return p;
  }
  while ((int64_t)p.wpr * 32 * MAX_NV < nvec) p.wpr *= 2;
  const int64_t per_lane = (nvec + 32 * p.wpr - 1) / (32 * p.wpr);
  for (int nv : NVS)
    if (nv >= per_lane) {
      p.nv = nv;
      break;
    }
  if (p.wpr == 1)  // rows a block doubled while the grid still covers 3/4 of the SMs
    while (p.rpb < MAX_ROWS && 4 * ((rows + 2 * p.rpb - 1) / (2 * p.rpb)) >= 3 * (int64_t)sms)
      p.rpb *= 2;
  p.blocks = (rows + p.rpb - 1) / p.rpb;
  p.threads = 32 * p.wpr * p.rpb;
  p.smem = p.rpb > 1 ? (size_t)d * sizeof(float) : 0;
  return p;
}

template <typename T, typename G, int NV>
cudaError_t run(const Plan& p, const void* x, const void* gamma, void* out, int64_t rows,
                int64_t d, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, G, NV><<<(unsigned)p.blocks, p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma), static_cast<T*>(out), rows, d,
      eps, p.wpr, p.rpb);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gamma, void* out, int64_t rows, int64_t d,
                   float eps, int vec, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const Plan p = plan(rows, d, vec, (int)sizeof(T), sms);
  if (p.blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(gamma);
  T* op = static_cast<T*>(out);
  constexpr int V = 16 / sizeof(T);
  const unsigned blocks = (unsigned)p.blocks;
  switch (p.nv) {
    case 0:
      if (vec)
        rmsnorm_wide_kernel<T, G, V><<<blocks, p.threads, 0, stream>>>(xp, gp, op, d, eps);
      else
        rmsnorm_wide_kernel<T, G, 1><<<blocks, p.threads, 0, stream>>>(xp, gp, op, d, eps);
      return cudaGetLastError();
    case 1: return run<T, G, 1>(p, x, gamma, out, rows, d, eps, stream);
    case 2: return run<T, G, 2>(p, x, gamma, out, rows, d, eps, stream);
    case 4: return run<T, G, 4>(p, x, gamma, out, rows, d, eps, stream);
    case 6: return run<T, G, 6>(p, x, gamma, out, rows, d, eps, stream);
    case 8: return run<T, G, 8>(p, x, gamma, out, rows, d, eps, stream);
    case 12: return run<T, G, 12>(p, x, gamma, out, rows, d, eps, stream);
    case 16: return run<T, G, 16>(p, x, gamma, out, rows, d, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype, gamma_dtype: 0 float32, 1 bfloat16. x and out are dense (rows, d);
// gamma is dense (d,). vec != 0 takes 16-byte accesses: the caller sets it
// only when d is a multiple of 16 / sizeof(x's type) and x, gamma and out
// are aligned to that many of their own elements. Returns a cudaError_t (0
// on success); launches nothing for an empty input.
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

// The launch configuration of a call on a card of `sms` SMs: out = {CUDA
// kernels a call (1), blocks, threads, dynamic shared memory bytes, vectors
// a lane (0: the two-pass kernel for very wide rows), warps a row, rows a
// block}.
extern "C" int rmsnorm_config(int dtype, int64_t rows, int64_t d, int vec, int sms,
                              int64_t* out) {
  if (rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(rows, d, vec, dtype == 0 ? 4 : 2, sms);
  const int64_t vals[7] = {1, p.blocks, p.threads, (int64_t)p.smem, p.nv, p.wpr, p.rpb};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}
