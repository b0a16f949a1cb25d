// Flash attention, forward and backward, for Hopper (sm_90a), in CUDA C++.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel<T, D>      <- flash_attention (_flash_kernel, _flash_kernel_lse)
//   flash_bwd_dq_kernel<T, D>   <- flash_attention_bwd, pass 1 (_flash_bwd_dq_kernel)
//   flash_bwd_dkv_kernel<T, D>  <- flash_attention_bwd, pass 2 (_flash_bwd_dkv_kernel)
// and, through the autograd Function in repro_torch/kernels/ops.py, the
// custom_vjp flash_attention_trainable over the two.
//
// Function: causal and/or sliding-window GQA attention, q (B,Hq,Sq,D) and
// k, v (B,Hkv,Sk,D), kv head = q head / (Hq/Hkv); online softmax with f32
// running max, sum and accumulator; the forward also writes the f32
// log-sum-exp (B,Hq,Sq) from which the backward recomputes P = exp(s - lse).
// delta = rowsum(do * o) is computed by the caller, as the reference does.
// Positions are the row indices (query q sees key k iff k <= q when causal
// and q - k < window when window > 0); every query row must see a key.
//
// What bounds it on an H100: at the training step's shapes (B=2, H=16,
// S=256, D=64, f32, causal) arithmetic. The causal half of the score and
// value products is 0.27 GFLOP a forward call, 4.0 us at the 67 TFLOP/s
// float32 rate outside the tensor cores, against 2.5 us for its 8.4 MB of
// q, k, v and o. f32 inputs take no TF32 path (the reference's f32 numerics),
// so every product is an FMA on the CUDA cores; bf16 inputs are widened to
// f32 on load and run the same code.
//
// What the design does about it:
// * Every 64x64 product is register-tiled: a block of 128 threads (4 warps)
//   owns 64 rows, each thread 4 rows x 8 columns of the score tile, so one
//   pass over D does 128 FMAs for 12 16-byte shared-memory loads. Tiles sit
//   in shared memory in f32 with a row stride of D+4 floats, which keeps
//   those loads free of bank conflicts.
// * A row's 8 score columns live in the 8 lanes of one quarter-warp: the
//   online-softmax max and sum are three xor shuffles, with no shared
//   memory and no block barrier.
// * Tiles that the causal mask or the window hides entirely are skipped
//   (the Pallas grid visits and masks them); that computes the same
//   function.
// * Each block loops over the key (or query) tiles itself: CUDA blocks run
//   in no order, so nothing is carried from one block to another. The
//   dk/dv block owns one key tile of one kv head and loops over the G query
//   heads of its group, so the group sum the reference does outside its
//   kernel happens in f32 registers: no (B,Hq,Sk,D) partials, no atomics.
// * Any strides for the batch, head and sequence dimensions (the last
//   dimension must be dense): the decoder's (B,S,H,D) tensors go in as
//   (B,H,S,D) views without a copy.
// * Ragged sequence lengths: rows past the end load as zeros and are masked.
// A simple kernel that is right first: wgmma, TMA and pipelined loads are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows of a tile
constexpr int BK = 64;   // key rows of a tile
constexpr int NT = 128;  // threads of a block: 4 warps x 16 rows
constexpr int TS = 68;   // row stride (floats) of a 64x64 score tile in shared memory
constexpr float NEG_INF = -1e30f;

struct View {  // one (B, H, S, D) tensor: base pointer and element strides
  void* p;
  int64_t sb, sh, ss;
};

struct Params {
  View q, k, v, dout, o, dq, dk, dv;
  float* lse;
  const float* delta;
  int B, Hq, Hkv, Sq, Sk, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ T* slice(const View& t, int b, int h) {
  return static_cast<T*>(t.p) + (int64_t)b * t.sb + (int64_t)h * t.sh;
}

__device__ __forceinline__ bool visible(const Params& p, int q, int k) {
  return q < p.Sq && k < p.Sk && (!p.causal || k <= q) && (p.window <= 0 || q - k < p.window);
}

// reductions over the 8 lanes of a quarter-warp (one row of a score tile)
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// 64 rows of a (S, D) slice with row stride ss into shared memory (f32,
// row stride D+4), times scale; rows at or past nrows load as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t ss, int row0,
                                          int nrows, float scale) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx - r * D, gr = row0 + r;
    dst[r * LD + c] = gr < nrows ? to_f32(src[(int64_t)gr * ss + c]) * scale : 0.f;
  }
}

// acc[i][j] = A[r0 + 4i] . B[cg + 8j] over D: rows of two 64-row tiles.
template <int D>
__device__ __forceinline__ void tile_abt(const float* A, const float* B, int r0, int cg,
                                         float (&acc)[4][8]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (r0 + 4 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(B + (cg + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4c + e] += sum over 64 k of P[r0 + 4i][k] * V[k][4cg + 32c + e]:
// P a 64x64 score tile (row stride TS), V 64 rows of D (row stride D+4).
template <int D>
__device__ __forceinline__ void tile_pv(const float* P, const float* V, int r0, int cg,
                                        float (&acc)[4][D / 8]) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int k = 0; k < 64; k += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(P + (r0 + 4 * i) * TS + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(V + (k + e) * LD + 4 * cg + 32 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = comp(pr[i], e);
          acc[i][4 * c + 0] = fmaf(pk, v.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pk, v.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pk, v.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pk, v.w, acc[i][4 * c + 3]);
        }
      }
  }
}

// the thread's 4 rows of a (S, D) slice, columns 4cg + 32c + e, from acc * mul
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int64_t ss, int row0, int nrows, int r0,
                                           int cg, const float (&acc)[4][D / 8], float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + r0 + 4 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[(int64_t)r * ss + 4 * cg + 32 * c + e] = from_f32<T>(acc[i][4 * c + e] * mul);
  }
}

// [k_begin, k_end): the key tiles query tile q0 can see
__device__ __forceinline__ void key_range(const Params& p, int q0, int& k_begin, int& k_end) {
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  k_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
}

// [q_begin, q_end): the query tiles that can see key tile k0
__device__ __forceinline__ void query_range(const Params& p, int k0, int& q_begin, int& q_end) {
  const int k_last = min(k0 + BK, p.Sk) - 1;
  q_begin = p.causal ? k0 / BQ * BQ : 0;
  q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
}

// grid (ceil(Sq/64), Hq, B): o and lse of one query tile of one head
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 4, NC = D / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int lane = threadIdx.x & 31, cg = lane & 7;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 3);
  const T* k = slice<T>(p.k, b, hk);
  const T* v = slice<T>(p.v, b, hk);
  load_rows<T, D>(sQ, slice<T>(p.q, b, h), p.q.ss, q0, p.Sq, p.scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int k_begin, k_end;
  key_range(p, q0, k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(sK, k, p.k.ss, k0, p.Sk, 1.f);
    load_rows<T, D>(sV, v, p.v.ss, k0, p.Sk, 1.f);
    __syncthreads();
    float s[4][8];
    tile_abt<D>(sQ, sK, r0, cg, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + r0 + 4 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!visible(p, qi, k0 + cg + 8 * j)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        sP[(r0 + 4 * i) * TS + cg + 8 * j] = s[i][j];
      }
      l[i] = l[i] * corr + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    tile_pv<D>(sP, sV, r0, cg, acc);
  }

  T* o = slice<T>(p.o, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + 4 * i;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC / 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[(int64_t)qi * p.o.ss + 4 * cg + 32 * c + e] = from_f32<T>(acc[i][4 * c + e] / den);
    if (cg == 0) p.lse[((int64_t)b * p.Hq + h) * p.Sq + qi] = m[i] + logf(den);
  }
}

// grid (ceil(Sq/64), Hq, B): dq of one query tile of one head
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 4, NC = D / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int lane = threadIdx.x & 31, cg = lane & 7;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 3);
  const T* k = slice<T>(p.k, b, hk);
  const T* v = slice<T>(p.v, b, hk);
  load_rows<T, D>(sQ, slice<T>(p.q, b, h), p.q.ss, q0, p.Sq, p.scale);
  load_rows<T, D>(sDO, slice<T>(p.dout, b, h), p.dout.ss, q0, p.Sq, 1.f);

  float lse[4], delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + 4 * i;
    const int64_t row = ((int64_t)b * p.Hq + h) * p.Sq + qi;
    lse[i] = qi < p.Sq ? p.lse[row] : 0.f;
    delta[i] = qi < p.Sq ? p.delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int k_begin, k_end;
  key_range(p, q0, k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<T, D>(sK, k, p.k.ss, k0, p.Sk, 1.f);
    load_rows<T, D>(sV, v, p.v.ss, k0, p.Sk, 1.f);
    __syncthreads();
    float s[4][8], dp[4][8];
    tile_abt<D>(sQ, sK, r0, cg, s);
    tile_abt<D>(sDO, sV, r0, cg, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + r0 + 4 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sv = visible(p, qi, k0 + cg + 8 * j) ? s[i][j] : NEG_INF;
        const float pv = expf(sv - lse[i]);
        sS[(r0 + 4 * i) * TS + cg + 8 * j] = pv * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
    tile_pv<D>(sS, sK, r0, cg, acc);
  }
  store_rows<T, D>(slice<T>(p.dq, b, h), p.dq.ss, q0, p.Sq, r0, cg, acc, p.scale);
}

// grid (ceil(Sk/64), Hkv, B): dk and dv of one key tile of one kv head,
// summed over the G query heads of its group
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 4, NC = D / 8;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sDO = sQ + BQ * LD;
  float* sP = sDO + BQ * LD;
  float* sS = sP + BK * TS;
  float* sL = sS + BK * TS;
  float* sDelta = sL + BQ;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BK;
  const int G = p.Hq / p.Hkv;
  const int lane = threadIdx.x & 31, cg = lane & 7;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 3);
  load_rows<T, D>(sK, slice<T>(p.k, b, hk), p.k.ss, k0, p.Sk, 1.f);
  load_rows<T, D>(sV, slice<T>(p.v, b, hk), p.v.ss, k0, p.Sk, 1.f);

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  int q_begin, q_end;
  query_range(p, k0, q_begin, q_end);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q = slice<T>(p.q, b, h);
    const T* dout = slice<T>(p.dout, b, h);
    const int64_t row0 = ((int64_t)b * p.Hq + h) * p.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();
      load_rows<T, D>(sQ, q, p.q.ss, q0, p.Sq, p.scale);
      load_rows<T, D>(sDO, dout, p.dout.ss, q0, p.Sq, 1.f);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const bool in = q0 + r < p.Sq;
        sL[r] = in ? p.lse[row0 + q0 + r] : 0.f;
        sDelta[r] = in ? p.delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][8], dp[4][8];
      tile_abt<D>(sK, sQ, r0, cg, s);    // s[i][j]: key k0+r0+4i against query q0+cg+8j
      tile_abt<D>(sV, sDO, r0, cg, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ki = k0 + r0 + 4 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cg + 8 * j;
          const float sv = visible(p, q0 + c, ki) ? s[i][j] : NEG_INF;
          const float pv = expf(sv - sL[c]);
          sP[(r0 + 4 * i) * TS + c] = pv;
          sS[(r0 + 4 * i) * TS + c] = pv * (dp[i][j] - sDelta[c]);
        }
      }
      __syncthreads();
      tile_pv<D>(sP, sDO, r0, cg, acc_v);
      tile_pv<D>(sS, sQ, r0, cg, acc_k);
    }
  }
  store_rows<T, D>(slice<T>(p.dk, b, hk), p.dk.ss, k0, p.Sk, r0, cg, acc_k, 1.f);
  store_rows<T, D>(slice<T>(p.dv, b, hk), p.dv.ss, k0, p.Sk, r0, cg, acc_v, 1.f);
}

// ---- host side: one launcher per kernel, dispatched on (dtype, D) ----

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const Params& p, cudaStream_t stream) {
  const size_t smem = ((BQ + 2 * BK) * (D + 4) + BQ * TS) * sizeof(float);
  return launch(flash_fwd_kernel<T, D>, dim3((p.Sq + BQ - 1) / BQ, p.Hq, p.B), smem, stream, p);
}

template <typename T, int D>
cudaError_t bwd_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = ((2 * BQ + 2 * BK) * (D + 4) + BQ * TS) * sizeof(float);
  return launch(flash_bwd_dq_kernel<T, D>, dim3((p.Sq + BQ - 1) / BQ, p.Hq, p.B), smem, stream,
                p);
}

template <typename T, int D>
cudaError_t bwd_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = ((2 * BQ + 2 * BK) * (D + 4) + 2 * BK * TS + 2 * BQ) * sizeof(float);
  return launch(flash_bwd_dkv_kernel<T, D>, dim3((p.Sk + BK - 1) / BK, p.Hkv, p.B), smem,
                stream, p);
}

// dtype: 0 float32, 1 bfloat16; D: 32, 64 or 128
#define FLASH_DISPATCH(FN, p, stream)                              \
  switch (dtype * 1000 + D) {                                      \
    case 32: return FN<float, 32>(p, stream);                      \
    case 64: return FN<float, 64>(p, stream);                      \
    case 128: return FN<float, 128>(p, stream);                    \
    case 1032: return FN<__nv_bfloat16, 32>(p, stream);            \
    case 1064: return FN<__nv_bfloat16, 64>(p, stream);            \
    case 1128: return FN<__nv_bfloat16, 128>(p, stream);           \
    default: return cudaErrorInvalidValue;                         \
  }

Params make_params(int D, int B, int Hq, int Hkv, int Sq, int Sk, int causal, int window) {
  Params p = {};
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.scale = (float)(1.0 / sqrt((double)D));  // D ** -0.5, rounded once to f32
  return p;
}

View view(const void* ptr, int64_t sb, int64_t sh, int64_t ss) {
  return View{const_cast<void*>(ptr), sb, sh, ss};
}

cudaError_t run_fwd(int dtype, int D, const Params& p, cudaStream_t stream) {
  FLASH_DISPATCH(fwd, p, stream)
}
cudaError_t run_dq(int dtype, int D, const Params& p, cudaStream_t stream) {
  FLASH_DISPATCH(bwd_dq, p, stream)
}
cudaError_t run_dkv(int dtype, int D, const Params& p, cudaStream_t stream) {
  FLASH_DISPATCH(bwd_dkv, p, stream)
}

}  // namespace

// Each (B,H,S,D) tensor is passed as its pointer and its batch, head and
// sequence strides in elements. lse and delta are dense (B,Hq,Sq) float32.
// Returns the cudaError_t of the launch (0 on success).

extern "C" int flash_attention_fwd(int dtype, int D, int B, int Hq, int Hkv, int Sq, int Sk,
                                   int causal, int window,
                                   const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   void* o, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   float* lse, void* stream) {
  Params p = make_params(D, B, Hq, Hkv, Sq, Sk, causal, window);
  p.q = view(q, q_sb, q_sh, q_ss);
  p.k = view(k, k_sb, k_sh, k_ss);
  p.v = view(v, v_sb, v_sh, v_ss);
  p.o = view(o, o_sb, o_sh, o_ss);
  p.lse = lse;
  return (int)run_fwd(dtype, D, p, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dq(int dtype, int D, int B, int Hq, int Hkv, int Sq, int Sk,
                                      int causal, int window,
                                      const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                      const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                      const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                      const void* dout, int64_t do_sb, int64_t do_sh,
                                      int64_t do_ss, const float* lse, const float* delta,
                                      void* dq, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
                                      void* stream) {
  Params p = make_params(D, B, Hq, Hkv, Sq, Sk, causal, window);
  p.q = view(q, q_sb, q_sh, q_ss);
  p.k = view(k, k_sb, k_sh, k_ss);
  p.v = view(v, v_sb, v_sh, v_ss);
  p.dout = view(dout, do_sb, do_sh, do_ss);
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = view(dq, dq_sb, dq_sh, dq_ss);
  return (int)run_dq(dtype, D, p, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dkv(int dtype, int D, int B, int Hq, int Hkv, int Sq, int Sk,
                                       int causal, int window,
                                       const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                       const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                       const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                       const void* dout, int64_t do_sb, int64_t do_sh,
                                       int64_t do_ss, const float* lse, const float* delta,
                                       void* dk, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                                       void* dv, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                                       void* stream) {
  Params p = make_params(D, B, Hq, Hkv, Sq, Sk, causal, window);
  p.q = view(q, q_sb, q_sh, q_ss);
  p.k = view(k, k_sb, k_sh, k_ss);
  p.v = view(v, v_sb, v_sh, v_ss);
  p.dout = view(dout, do_sb, do_sh, do_ss);
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dk = view(dk, dk_sb, dk_sh, dk_ss);
  p.dv = view(dv, dv_sb, dv_sh, dv_ss);
  return (int)run_dkv(dtype, D, p, static_cast<cudaStream_t>(stream));
}
