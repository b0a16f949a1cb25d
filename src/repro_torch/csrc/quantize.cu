// int8 error-feedback gossip wire for Hopper (sm_90a), in CUDA C++.
//
// Replaces the TPU kernels of src/repro/kernels/quantize.py:
//   quantize_plane_kernel<T>          <- quantize_plane (_quant_kernel)
//   dequant_mix_kernel<T, true>       <- dequant_mix (_dequant_mix_kernel)
//   dequant_mix_kernel<T, false>      <- dequant_mix (_dequant_mix_kernel_pure)
// T is float or __nv_bfloat16 (the plane's dtype).
//
// Function. A stacked (M, n) plane buffer is quantized PER WORKER: worker m
// has rows(n) rows (quant_layout: ceil(ceil(n/128)/32)*32, rounded up to
// whole tiles of 256 rows), row j covering elements [128j, 128j+128) of its
// own n; elements past n read as 0, so padding rows get scale 1.0. For each
// row:
//   v = x + r                     (f32)
//   s = absmax(v) / 127           (1.0 where absmax is 0)
//   q = clip(round_half_even(v / s), -127, 127)        int8
//   r' = v - q*s                  (stored in T)
// and the receive side, elementwise, with per-worker alpha/beta (M,) on the
// device:
//   o = ((a[m]*x) + (b[m]*(q*s[m][row]))) [+ u]       (f32, stored in T)
//
// Rounding. The kernels are meant to be bit-identical to their plain
// PyTorch versions (repro_torch/kernels/ref.py), which evaluate the same
// formulas one PyTorch operation at a time. So every operation is spelled
// with its rounding and nothing is contracted into an FMA: __fadd_rn,
// __fsub_rn, __fmul_rn and __fdiv_rn (correctly rounded division; the plain
// version divides by a TENSOR of 127s, because PyTorch's CUDA division by a
// Python scalar multiplies by the reciprocal instead), rintf (halves to
// even, as torch.round; roundf would round them away from zero) and
// __float2bfloat16_rn. The absmax propagates NaN as torch.amax does, and the
// clip passes NaN through as torch.clamp does.
//
// What bounds it on an H100: device memory. At the training step's shapes
// (M=4, GPT-2 Medium's groups of 402,702,336 + 51,463,168 + 1,024 elements,
// f32) quantize_plane reads x and r and writes q and r' (13 B an element),
// dequant_mix with the update reads x, q and u and writes o (13 B), the pure
// variant 9 B; plus 4 B of scale a row. About nine flops an element are
// three orders of magnitude below the card's rate.
//
// What the design does about it:
// * One pass over each operand, no padded copy of the plane: the ragged
//   tail of each worker's row is masked, and padding rows only write their
//   scale.
// * quantize_plane: one warp per 128-element row, lane l holding elements
//   l, l+32, l+64 and l+96, so each of a warp's four loads of an operand is
//   one coalesced 128-byte (f32) line; the row's absmax is a five-step
//   __shfl_xor_sync reduction in registers. A row is read whole before any
//   of it is written, so r' may be written over r in place.
// * dequant_mix: a 2-D grid (block of a worker's row, worker): alpha, beta
//   and the row index come from the block's coordinates without a 64-bit
//   division per element; each thread handles 4 elements 256 apart
//   (coalesced); o may be x itself (each element is read and then written
//   by the same thread).
// * Offsets are int64: the stacked blocks group at M=4 is 1.61e9 elements,
//   75% of 2^31.
// A simple kernel that is right first: vector loads and packing four int8
// values into one store are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;          // elements of a quantization row
constexpr int QUANT_WARPS = 8;     // rows (warps) of a quantize block
constexpr int MIX_THREADS = 256;   // threads of a dequant_mix block
constexpr int MIX_PER_THREAD = 4;  // elements of a dequant_mix thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// max that propagates NaN (torch.amax), unlike fmaxf
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__global__ void quantize_plane_kernel(const T* x, const T* r, int8_t* q, float* s, T* r_out,
                                      int64_t M, int64_t n, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t grow = (int64_t)blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);
  if (grow >= M * rows) return;  // whole warps leave together
  const int64_t m = grow / rows;
  const int64_t j = grow - m * rows;
  const int64_t base = m * n;  // worker m's first element
  float v[4];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t e = j * LANE + lane + 32 * k;
    float val = 0.f;
    if (e < n) {
      val = to_f32(x[base + e]);
      if (r != nullptr) val = __fadd_rn(val, to_f32(r[base + e]));
    }
    v[k] = val;
    amax = nan_max(amax, fabsf(val));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  if (lane == 0) s[grow] = scale;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t e = j * LANE + lane + 32 * k;
    if (e < n) {
      float t = rintf(__fdiv_rn(v[k], scale));
      if (t == t) t = fminf(fmaxf(t, -127.f), 127.f);
      q[base + e] = static_cast<int8_t>(t);
      r_out[base + e] = from_f32<T>(__fsub_rn(v[k], __fmul_rn(t, scale)));
    }
  }
}

template <typename T, bool WITH_UPD>
__global__ void dequant_mix_kernel(const T* x, const int8_t* q, const float* s, const T* u,
                                   const float* alpha, const float* beta, T* out, int64_t n,
                                   int64_t rows) {
  const int64_t m = blockIdx.y;
  const float a = alpha[m], b = beta[m];
  const int64_t first = (int64_t)blockIdx.x * (MIX_THREADS * MIX_PER_THREAD) + threadIdx.x;
  const int64_t base = m * n;
  const float* srow = s + m * rows;
#pragma unroll
  for (int k = 0; k < MIX_PER_THREAD; ++k) {
    const int64_t e = first + (int64_t)k * MIX_THREADS;
    if (e < n) {
      const float deq = __fmul_rn(static_cast<float>(q[base + e]), srow[e / LANE]);
      float o = __fadd_rn(__fmul_rn(a, to_f32(x[base + e])), __fmul_rn(b, deq));
      if (WITH_UPD) o = __fadd_rn(o, to_f32(u[base + e]));
      out[base + e] = from_f32<T>(o);
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, const void* r, int8_t* q, float* s, void* r_out,
                            int64_t M, int64_t n, int64_t rows, cudaStream_t stream) {
  const int64_t blocks = (M * rows + QUANT_WARPS - 1) / QUANT_WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  quantize_plane_kernel<T><<<(unsigned)blocks, QUANT_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), q, s, static_cast<T*>(r_out), M, n,
      rows);
  return cudaGetLastError();
}

template <typename T, bool WITH_UPD>
cudaError_t launch_mix(const void* x, const int8_t* q, const float* s, const void* u,
                       const float* alpha, const float* beta, void* out, int64_t M, int64_t n,
                       int64_t rows, cudaStream_t stream) {
  const int64_t per_block = MIX_THREADS * MIX_PER_THREAD;
  const int64_t bx = (n + per_block - 1) / per_block;
  if (bx > 0x7fffffffLL || M > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)bx, (unsigned)M);
  dequant_mix_kernel<T, WITH_UPD><<<grid, MIX_THREADS, 0, stream>>>(
      static_cast<const T*>(x), q, s, static_cast<const T*>(u), alpha, beta,
      static_cast<T*>(out), n, rows);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. r may be null (a zero residual); r_out may
// equal r. Returns a cudaError_t (0 on success); launches nothing for an
// empty buffer.
extern "C" int quantize_plane(int dtype, int64_t M, int64_t n, int64_t rows, const void* x,
                              const void* r, int8_t* q, float* s, void* r_out, void* stream) {
  if (M <= 0 || rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_quantize<float>(x, r, q, s, r_out, M, n, rows, st);
  if (dtype == 1) return (int)launch_quantize<__nv_bfloat16>(x, r, q, s, r_out, M, n, rows, st);
  return (int)cudaErrorInvalidValue;
}

// u is ignored when with_upd is 0; out may equal x.
extern "C" int dequant_mix(int dtype, int with_upd, int64_t M, int64_t n, int64_t rows,
                           const void* x, const int8_t* q, const float* s, const void* u,
                           const float* alpha, const float* beta, void* out, void* stream) {
  if (M <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(with_upd ? launch_mix<float, true>(x, q, s, u, alpha, beta, out, M, n, rows, st)
                          : launch_mix<float, false>(x, q, s, u, alpha, beta, out, M, n, rows, st));
  if (dtype == 1)
    return (int)(with_upd
                     ? launch_mix<__nv_bfloat16, true>(x, q, s, u, alpha, beta, out, M, n, rows, st)
                     : launch_mix<__nv_bfloat16, false>(x, q, s, u, alpha, beta, out, M, n, rows,
                                                        st));
  return (int)cudaErrorInvalidValue;
}
