// Mamba2 SSD chunked scan for Hopper (sm_90a), in CUDA C++.
//
// Replaces the TPU kernel of src/repro/kernels/ssd_scan.py (ssd_scan, its
// _ssd_kernel). x (B, H, S, P), dt (B, H, S), A (H,) f32, Bm/Cm (B, S, N)
// shared across heads -> y (B, H, S, P) in x's dtype. Per chunk of Q steps
// of one (b, h), all in f32 (the Pallas kernel's preferred_element_type):
//   cum   = inclusive scan of dt*A over the chunk
//   W     = (C Bt) * exp(cum_i - cum_j)[i >= j] * dt_j       (Q x Q)
//   y     = W x + exp(cum) * (C state)                        (Q x P)
//   state = state * exp(cum_last) + (B * exp(cum_last - cum) * dt)t x   (N x P)
// T (x, Bm, Cm, y) and TD (dt) are each float or __nv_bfloat16.
//
// The TPU kernel keeps the (N, P) state in VMEM scratch across a sequential
// grid axis of chunks. Blocks on Hopper run in no order, so here the chunk
// loop is inside the block: one block per (b, h) and tile of PT = 64 state
// columns walks the S/Q chunks in order, with its slice of the state in
// shared memory. The state's P columns are independent, so the grid
// (B*H, ceil(P/64)) is exact without any cross-block sum. At the Mamba2
// step's shape (B=2, H=48, P=64) that is 96 blocks of 16 warps for 132
// SMs; splitting P further would fill the SMs but repeat C Bt per block.
//
// What bounds it on an H100: operations. At that shape (S=256, Q=128,
// N=128) the function's work, counted over i >= j with C Bt once per
// (b, chunk) since Bm and Cm are shared across heads, is about 1.02 GFLOP
// in f32, about 15 us at the 67 TFLOP/s f32 rate outside the tensor
// cores; its bytes (x, dt, Bm, Cm and y once, ~3.5 MB in bf16) take about
// 1 us. This kernel does about 1.42 GFLOP: it recomputes C Bt for every
// head, as the TPU kernel does.
//
// What the design does:
// * Shared memory holds one chunk: B transposed (N x Q), x's 64 columns
//   (Q x 64), the state slice (N x 64), and a tile of QT = 64 rows of C
//   and of W (C and W are made and used a row tile at a time, so a 128 x
//   128 f32 W never needs its 64 KB). Rows are padded to 4 floats with
//   zeros (chunk, state or columns not a multiple of 4 or 64 need no other
//   path) and read as 16-byte vectors. At Q = N = 128: 196 KB, dynamic.
// * Register tiles, so that a shared read feeds several FMAs: W's tile,
//   4 rows x 4 columns 32 apart a thread over the N-long dot products (only
//   the column groups with some j <= i of the tile's last row are read);
//   y, 4 rows x 2 columns (lane, lane + 32) a thread over j <= i and n;
//   the state update, 8 rows x 2 columns a thread over the chunk. Reads of
//   W, C, B and the decay weights are warp broadcasts (the warp shares its
//   rows), reads of x and the state are consecutive across lanes.
// * The exponential of cum_i - cum_j is taken only where i >= j: above the
//   diagonal the difference is positive and may overflow.
// * The inclusive scan of dt*A is a serial loop of one thread (Q adds).
// * Inputs are read through their strides (the model's (B, S, H, P) x and
//   (B, S, H) dt pass as (B, H, S, P) and (B, H, S) views, Bm and Cm as
//   column slices of one (B, S, C) tensor); the last axis must be dense.
//   Offsets are int64.
// A simple kernel that is right first. Later gains: C Bt once per (b,
// chunk) instead of per head; tensor cores (mma/wgmma) for the three chunk
// products; overlapping the next chunk's loads with this one's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;  // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int PT = 64;        // state columns of a block: lane and lane + 32
constexpr int QT = 64;        // rows of a C / W tile: 4 a warp
constexpr int QMAX = 128;     // chunk length the register tiles allow
constexpr int NMAX = 128;     // state size: 8 state rows a warp
static_assert(WARPS * 4 == QT && WARPS * 8 == NMAX && PT == 64, "thread layout");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

struct Args {
  int64_t H, S, P, N, Q;
  const void* x; int64_t xsb, xsh, xss;
  const void* dt; int64_t dsb, dsh, dss;
  const float* A;
  const void* bm; int64_t bsb, bss;
  const void* cm; int64_t csb, css;
  void* y; int64_t ysb, ysh, yss;
};

// Shared floats of a block: B transposed, C and W tiles, x, state, and
// three chunk vectors; rows padded to 4 floats (16-byte vector reads)
__host__ __device__ inline int64_t smem_floats(int Q, int N) {
  const int Q4 = round4(Q), N4 = round4(N);
  return (int64_t)N4 * (Q4 + 4) + QT * N4 + QT * Q4 + Q4 * PT + N4 * PT + 3 * Q4;
}

template <typename T, typename TD>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Q = (int)a.Q, N = (int)a.N, Q4 = round4(Q), N4 = round4(N), QB = Q4 + 4;
  float* s_Bt = smem;               // [n][j], row stride Q4 + 4
  float* s_C = s_Bt + N4 * QB;      // [r][n], QT rows of the tile
  float* s_W = s_C + QT * N4;       // [r][j], QT rows of the tile
  float* s_x = s_W + QT * Q4;       // [j][p]
  float* s_state = s_x + Q4 * PT;   // [n][p]
  float* s_cum = s_state + N4 * PT; // [j]
  float* s_dt = s_cum + Q4;         // [j]
  float* s_w = s_dt + Q4;           // [j] exp(cum_last - cum_j) * dt_j

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int64_t p0 = (int64_t)blockIdx.y * PT;
  const float A = a.A[h];
  const T* x = static_cast<const T*>(a.x) + b * a.xsb + h * a.xsh + p0;
  const TD* dt = static_cast<const TD*>(a.dt) + b * a.dsb + h * a.dsh;
  const T* bm = static_cast<const T*>(a.bm) + b * a.bsb;
  const T* cm = static_cast<const T*>(a.cm) + b * a.csb;
  T* y = static_cast<T*>(a.y) + b * a.ysb + h * a.ysh + p0;

  for (int i = tid; i < N4 * PT; i += THREADS) s_state[i] = 0.f;

  const int64_t nc = a.S / Q;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s0 = c * Q;
    // ---- the chunk's dt, B (transposed) and x; zero padding past Q, N, P
    for (int j = tid; j < Q4; j += THREADS)
      s_dt[j] = j < Q ? to_f32(dt[(s0 + j) * a.dss]) : 0.f;
    for (int i = tid; i < N4 * Q4; i += THREADS) {
      const int j = i / N4, n = i - j * N4;
      s_Bt[n * QB + j] = (j < Q && n < N) ? to_f32(bm[(s0 + j) * a.bss + n]) : 0.f;
    }
    for (int i = tid; i < Q4 * PT; i += THREADS) {
      const int j = i / PT, p = i - j * PT;
      s_x[i] = (j < Q && p0 + p < a.P) ? to_f32(x[(s0 + j) * a.xss + p]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive scan of dt * A
      float run = 0.f;
      for (int j = 0; j < Q; ++j) {
        run = __fadd_rn(run, __fmul_rn(s_dt[j], A));
        s_cum[j] = run;
      }
      for (int j = Q; j < Q4; ++j) s_cum[j] = run;
    }
    __syncthreads();
    const float cum_last = s_cum[Q - 1];
    for (int j = tid; j < Q4; j += THREADS)
      s_w[j] = j < Q ? __fmul_rn(expf(__fsub_rn(cum_last, s_cum[j])), s_dt[j]) : 0.f;

    const int r0 = 4 * warp;  // this warp's 4 rows of a tile
    for (int i0 = 0; i0 < Q; i0 += QT) {
      for (int i = tid; i < QT * N4; i += THREADS) {
        const int r = i / N4, n = i - r * N4;
        s_C[i] = (i0 + r < Q && n < N) ? to_f32(cm[(s0 + i0 + r) * a.css + n]) : 0.f;
      }
      __syncthreads();
      {  // ---- W's tile: rows r0..r0+3, columns lane + 32k
        const int kn = (min(Q, i0 + QT) + 31) / 32;  // column groups with some j <= i
        float acc[4][QMAX / 32];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < QMAX / 32; ++k) acc[r][k] = 0.f;
        for (int n = 0; n < N4; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&s_C[(r0 + r) * N4 + n]);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            float bv[QMAX / 32];
#pragma unroll
            for (int k = 0; k < QMAX / 32; ++k) {
              const int j = lane + 32 * k;
              bv[k] = (k < kn && j < Q4) ? s_Bt[(n + nn) * QB + j] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < QMAX / 32; ++k)
                acc[r][k] = fmaf(comp(cv[r], nn), bv[k], acc[r][k]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r0 + r;
#pragma unroll
          for (int k = 0; k < QMAX / 32; ++k) {
            const int j = lane + 32 * k;
            if (j < Q4) {
              float w = 0.f;  // the exponential only where i >= j
              if (i < Q && j <= i)
                w = __fmul_rn(__fmul_rn(acc[r][k], expf(__fsub_rn(s_cum[i], s_cum[j]))),
                              s_dt[j]);
              s_W[(r0 + r) * Q4 + j] = w;
            }
          }
        }
      }
      __syncthreads();
      if (i0 + r0 < Q) {  // ---- y rows: W x + exp(cum) (C state); warp-uniform
        const int jmax = min(i0 + r0 + 4, Q);
        float acc[4][2], inter[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = inter[r][0] = inter[r][1] = 0.f;
        for (int j = 0; j < jmax; j += 4) {
          float4 wv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            wv[r] = *reinterpret_cast<const float4*>(&s_W[(r0 + r) * Q4 + j]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float x0 = s_x[(j + jj) * PT + lane], x1 = s_x[(j + jj) * PT + lane + 32];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][0] = fmaf(comp(wv[r], jj), x0, acc[r][0]);
              acc[r][1] = fmaf(comp(wv[r], jj), x1, acc[r][1]);
            }
          }
        }
        for (int n = 0; n < N4; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&s_C[(r0 + r) * N4 + n]);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            const float t0 = s_state[(n + nn) * PT + lane];
            const float t1 = s_state[(n + nn) * PT + lane + 32];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              inter[r][0] = fmaf(comp(cv[r], nn), t0, inter[r][0]);
              inter[r][1] = fmaf(comp(cv[r], nn), t1, inter[r][1]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r0 + r;
          if (i < Q) {
            const float e = expf(s_cum[i]);
#pragma unroll
            for (int q = 0; q < 2; ++q)
              if (p0 + lane + 32 * q < a.P)
                y[(s0 + i) * a.yss + lane + 32 * q] = from_f32<T>(acc[r][q] + e * inter[r][q]);
          }
        }
      }
      __syncthreads();  // the next tile rewrites s_C and s_W
    }
    // ---- state <- state * exp(cum_last) + (B * w)t x; rows 8*warp + (0..7)
    const int n0 = 8 * warp;
    if (n0 < N4) {
      const float decay = expf(cum_last);
      float acc[8][2];
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) acc[nn][0] = acc[nn][1] = 0.f;
      for (int j = 0; j < Q4; j += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&s_w[j]);
        float x0[4], x1[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          x0[jj] = s_x[(j + jj) * PT + lane];
          x1[jj] = s_x[(j + jj) * PT + lane + 32];
        }
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          if (n0 + nn < N4) {
            const float4 bv = *reinterpret_cast<const float4*>(&s_Bt[(n0 + nn) * QB + j]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float bw = __fmul_rn(comp(bv, jj), comp(wv, jj));
              acc[nn][0] = fmaf(bw, x0[jj], acc[nn][0]);
              acc[nn][1] = fmaf(bw, x1[jj], acc[nn][1]);
            }
          }
        }
      }
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        if (n0 + nn < N4) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float* st = &s_state[(n0 + nn) * PT + lane + 32 * q];
            *st = fmaf(*st, decay, acc[nn][q]);
          }
        }
      }
    }
    __syncthreads();  // the next chunk rewrites s_Bt, s_x, s_dt, s_w
  }
}

template <typename T, typename TD>
cudaError_t launch(const Args& a, int64_t B, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats((int)a.Q, (int)a.N);
  auto kernel = ssd_scan_kernel<T, TD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(B * a.H), (unsigned)((a.P + PT - 1) / PT));
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype (x, Bm, Cm, y) and dt_dtype: 0 float32, 1 bfloat16. Strides are in
// elements; the last axis of x, Bm, Cm and y is dense. chunk (Q) divides S,
// 1 <= Q <= 128 and 1 <= N <= 128. Returns a cudaError_t (0 on success);
// launches nothing for an empty input.
extern "C" int ssd_scan(int dtype, int dt_dtype, int64_t B, int64_t H, int64_t S, int64_t P,
                        int64_t N, int64_t chunk, const void* x, int64_t xsb, int64_t xsh,
                        int64_t xss, const void* dt, int64_t dsb, int64_t dsh, int64_t dss,
                        const float* A, const void* bm, int64_t bsb, int64_t bss,
                        const void* cm, int64_t csb, int64_t css, void* y, int64_t ysb,
                        int64_t ysh, int64_t yss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0) return 0;
  if (chunk < 1 || chunk > QMAX || S % chunk || N < 1 || N > NMAX || B * H > 0x7fffffffLL ||
      (P + PT - 1) / PT > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{H,  S,   P,   N,   chunk, x,  xsb, xsh, xss, dt,  dsb, dsh, dss,
               A,  bm,  bsb, bss, cm,    csb, css, y,   ysb, ysh, yss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dt_dtype == 0) return (int)launch<float, float>(a, B, st);
  if (dtype == 0 && dt_dtype == 1) return (int)launch<float, __nv_bfloat16>(a, B, st);
  if (dtype == 1 && dt_dtype == 0) return (int)launch<__nv_bfloat16, float>(a, B, st);
  if (dtype == 1 && dt_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
