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
// What bounds it on an H100: operations in bf16, bytes in f32. At the
// Mamba2 step's shape (B=2, H=48, S=256, P=64, N=128, Q=128) y needs 0.62
// GFLOP, counted over i >= j, C Bt once per (b, chunk), C state from the
// second chunk on and the ingest up to the last chunk but one: C Bt on
// exact bf16 operands at the bf16 tensor-core rate, W x, C state and the
// ingest (one f32 operand, one exact bf16) at the 2xTF32 rate (247.5
// TFLOP/s), the decay weights at the f32 rate: about 2.5 us, against 2.0
// us for its bytes (x, dt, Bm, Cm and y once, 6.65 MB). In f32 the products
// take 3xTF32 (165 TFLOP/s), 3.8 us, and the 13.2 MB of bytes 3.9 us.
//
// What the design does about it:
// * Chunk-parallel, two to four kernels a call, none with atomics:
//   0. ssd_pack_kernel, only for an x, Bm or Cm view that is not 16-byte
//      aligned (the model's Bm and Cm, slices of one (B, S, 2N+1) tensor):
//      one element a thread into aligned rows of the workspace, all loads
//      in flight at once. Copied element by element inside the chunk and
//      output kernels instead, the same latency-bound copy would repeat
//      in every head's block (Bm, Cm) or every P tile's (x).
//   1. ssd_chunk_kernel, grid (P tiles x chunks, H + Q/16, B). Blocks of
//      y < H compute the ingest (B * w)t x of their (b, h, chunk) into an
//      f32 workspace (every chunk but the last, whose ingest nothing
//      reads) and the chunk's cum_last; blocks of y >= H compute C Bt once
//      per (b, chunk), since Bm and Cm are shared across heads, one
//      16-row strip a block (one block per (b, chunk) would be the
//      kernel's longest), and store it in the order of the mma accumulator
//      fragments (a warp reads its 16 x 8 tile as one 16-byte load a lane).
//   2. ssd_state_kernel (only with more than two chunks), grid (state
//      elements / 1024, B x H): carries the f32 state across the chunks in
//      order, overwriting ingest c with the state after chunk c,
//      s_c = s_{c-1} exp(cum_last_c) + ingest_c. The state after chunk 0
//      is its ingest, so with two chunks (the step's shape) there is
//      nothing to carry and no launch. A thread loads the ingests of 8
//      chunks at once, so the chain waits on memory once per 8 chunks.
//   3. ssd_out_kernel, grid (P tiles x chunks, H, B):
//      y = exp(cum) (C s) + W x for every (b, h, chunk), s the state after
//      the chunk before (none for chunk 0). Warp w takes the row strips
//      w % 4 and Q/16 - 1 - w % 4 (a short causal strip and a long one, so
//      W x is balanced) and half of the 64 columns.
//   At the step's shape that is 96 ingest (the last chunk's blocks exit
//   at once) + 32 C Bt blocks, then 192 output blocks, of 8 warps, against
//   the 96 blocks of one per (b, h) that walked the chunks in order; at
//   S = 2048, 1440 + 256 and 1536.
// * Every product runs on the tensor cores: mma.sync m16n8k8 TF32 with f32
//   accumulators. An f32 operand is split x = hi + lo (hi: x's top 19
//   bits; lo: x - hi cut the same way, by masks, not cvt.rna, whose
//   compiled form costs three times the instructions) and a.b ~ lo_a.hi_b
//   + hi_a.lo_b + hi_a.hi_b, the small terms first (3xTF32, within ~1e-6
//   of f32 where one TF32 product is off by ~5e-4). bf16 values are exact
//   in TF32 (lo = 0), so the products of a zero low part are left out at
//   compile time: C Bt of bf16 operands is one product, W x, C state and
//   the ingest two. W, the state and B * w stay f32 (split, never rounded
//   to bf16).
// * W never leaves registers: each lane takes its C Bt fragment (rows g,
//   g + 8, columns 2t, 2t + 1), applies the decay and dt there, and feeds it
//   as the A operand with the k index permuted (A(g, t) <- W(g, 2t), A(g,
//   t + 4) <- W(g, 2t + 1)); x is read with its rows in the same order.
//   Each fragment comes from L2 while the one before is used. The
//   exponential of cum_i - cum_j is taken only where i >= j: above the
//   diagonal the difference is positive and may overflow. Column tiles
//   that lie wholly above the diagonal are skipped.
// * Tiles come in by 16-byte cp.async copies (zero-filled past the chunk,
//   the state size or P, so any Q, N and P run with the same code); in the
//   output kernel C and the state are one commit group and x a second, so
//   x is in flight while C s is multiplied. One chunk a block: the next
//   chunk's tiles are another block's, resident on the same SM (2 or 3
//   blocks an SM in bf16). An operand whose pointer or strides are
//   not 16-byte aligned (the wrapper says which, the launcher refuses a
//   false claim) is packed by kernel 0, so every tile takes cp.async. Row
//   strides are padded so that every fragment load is free of bank
//   conflicts.
// * The inclusive scan of dt*A runs in one warp: four steps a lane, then
//   a shuffle scan of the lanes' sums.
// * Inputs are read through their strides (the model's (B, S, H, P) x and
//   (B, S, H) dt pass as (B, H, S, P) and (B, H, S) views, Bm and Cm as
//   column slices of one (B, S, C) tensor); the last axis must be dense.
//   The f32 workspace (C Bt, states, cum_last, packed operands) is the
//   wrapper's.
// What holds it at ~16x its bound in bf16 (PERF.md): the output kernel,
// over half of the time at the step's shape (chip_smoke.py's
// torch.profiler breakdown), whose mma.sync products, fragment loads and hi/lo splits
// run far below the tensor cores' rate, then the launch gaps between the
// kernels. Left for later work: wgmma (TF32 wants K-major operands, so x
// would be transposed in shared memory) and TMA; a persistent grid that
// keeps each (b, h)'s state on chip across chunks and saves kernel 2 and
// its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int THREADS = 256;  // 8 warps: one 16-row strip of an output tile each
constexpr int PT = 64;        // columns of x, y and the state a block takes
constexpr int QMAX = 128;     // chunk length: 8 strips of 16
constexpr int NMAX = 128;     // state size: 8 strips of 16
constexpr int STATE_BATCH = 8;  // chunks whose ingest the state pass loads at once

// bits of the aligned argument: the operand takes 16-byte copies as it is
constexpr int AL_X = 1, AL_B = 2, AL_C = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride, in elements of esize bytes, of a shared tile `cols` wide:
// rows `target` 4-byte words apart modulo 32 (the banks), 16-byte aligned.
// target 4: conflict-free row-major A fragments and B fragments read with
// rows (2t, 2t + 1); target 8: B fragments (rows t, t + 4) and A fragments
// read transposed.
__host__ __device__ constexpr int tile_ld(int cols, int esize, int target) {
  return (round_up(cols * esize / 4, 32) + target) * 4 / esize;
}

struct Args {
  int64_t B, H, S, P, N, Q, nc, pt;  // pt: tiles of PT columns
  const void* x; int64_t xsb, xsh, xss;
  const void* dt; int64_t dsb, dsh, dss;
  const float* A;
  const void* bm; int64_t bsb, bss;
  const void* cm; int64_t csb, css;
  void* y; int64_t ysb, ysh, yss;
  float* cb;      // (B, nc) C Bt tiles in fragment order, cb_floats() each
  float* states;  // (B, H, nc, N, pt * PT): ingest of chunk c, then the state after it
  float* cl;      // (B, H, nc): cum_last of each chunk
};

// The fragment-ordered C Bt of one (b, chunk): strips of 16 rows s, column
// tiles of 8 jt, 32 lanes x 4 floats a tile
__host__ __device__ inline int64_t cb_floats(int Q) {
  const int QP = round_up(Q, 16);
  return (int64_t)(QP / 16) * (QP / 8) * 128;
}

// ---- asynchronous copies ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` x `cols` tile (cols a multiple of 16 bytes' elements) into shared
// memory with row stride ld, from rows of stride rs, by 16-byte cp.async
// copies (the source's pointer and row stride are 16-byte aligned: a
// misaligned operand was packed first); rows at or past nrows and columns
// at or past ncols become zeros.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src, int64_t rs, int rows,
                                          int nrows, int cols, int ncols) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = cols / E;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += THREADS) {
    const int r = idx / cpr, c = (idx - r * cpr) * E;
    const int n = r < nrows ? min(max(ncols - c, 0), E) : 0;
    cp_async16(dst + r * ld + c, n ? src + r * rs + c : src, n * (int)sizeof(T));
  }
}

// dt of the chunk into s_dt (zeros past Q), and the inclusive scan of
// dt*A into s_cum by warp 0 (lane l holds steps 4l .. 4l + 3): the caller
// syncs between the two calls and after the second
template <typename TD>
__device__ __forceinline__ void load_dt(float* s_dt, const TD* dt, int64_t dss, int Q) {
  for (int j = threadIdx.x; j < QMAX; j += THREADS)
    s_dt[j] = j < Q ? to_f32(dt[(int64_t)j * dss]) : 0.f;
}
__device__ __forceinline__ void scan_cum(float* s_cum, const float* s_dt, float A) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float v[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run = __fadd_rn(run, __fmul_rn(s_dt[4 * lane + k], A));
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, o);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) s_cum[4 * lane + k] = __fadd_rn(excl, v[k]);
}

// ---- tensor-core products in 3xTF32 ----

struct A4 { uint32_t hi[4], lo[4]; };  // A fragment of m16n8k8, split
struct B2 { uint32_t hi[2], lo[2]; };  // B fragment

// x = hi + lo in TF32: hi keeps x's sign, exponent and top 10 mantissa
// bits, lo is the rest, exact in f32, cut to TF32 the same way (|lo| <
// 2^-10 |x|, so what is cut is below 2^-20 |x|). Three integer and float
// instructions, where cvt.rna.tf32.f32 compiles to four with an inf check;
// inf and NaN stay what they are in hi. EXACT: x is a bf16 value, exact in
// TF32, lo = 0.
constexpr uint32_t TF32_MASK = 0xffffe000u;
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = EXACT ? __float_as_uint(x) : __float_as_uint(x) & TF32_MASK;
  lo = EXACT ? 0u : __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in 3xTF32, the small terms first; a product with a low part that
// is 0 (an exact operand) is left out at compile time
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const A4& a, const B2& b) {
  if (!A_EXACT) mma(c, a.lo, b.hi);
  if (!B_EXACT) mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// Fragment lanes: g = lane / 4 and t = lane % 4. The accumulator c of a
// 16x8 tile holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).

// A = rows r0 .. r0+15, columns k0 .. k0+7 of a row-major tile
template <bool EXACT, typename T>
__device__ __forceinline__ void load_a(A4& a, const T* s, int ld, int r0, int k0, int g, int t) {
  const T* p = s + (r0 + g) * ld + k0 + t;
  split<EXACT>(to_f32(p[0]), a.hi[0], a.lo[0]);
  split<EXACT>(to_f32(p[8 * ld]), a.hi[1], a.lo[1]);
  split<EXACT>(to_f32(p[4]), a.hi[2], a.lo[2]);
  split<EXACT>(to_f32(p[8 * ld + 4]), a.hi[3], a.lo[3]);
}

// B of A.Xt, X a row-major [n][k] tile: (k, n) = X[n0 + n][k0 + k]
template <bool EXACT, typename T>
__device__ __forceinline__ void load_bt(B2& b, const T* s, int ld, int n0, int k0, int g, int t) {
  const T* p = s + (n0 + g) * ld + k0 + t;
  split<EXACT>(to_f32(p[0]), b.hi[0], b.lo[0]);
  split<EXACT>(to_f32(p[4]), b.hi[1], b.lo[1]);
}

// B of A.X, X a row-major [k][n] tile: (k, n) = X[k0 + k][n0 + n]
template <bool EXACT, typename T>
__device__ __forceinline__ void load_b(B2& b, const T* s, int ld, int n0, int k0, int g, int t) {
  const T* p = s + (k0 + t) * ld + n0 + g;
  split<EXACT>(to_f32(p[0]), b.hi[0], b.lo[0]);
  split<EXACT>(to_f32(p[4 * ld]), b.hi[1], b.lo[1]);
}

// B of W.X with the k index in the order of an A taken from an
// accumulator: k = t reads row k0 + 2t, k = t + 4 reads row k0 + 2t + 1
template <bool EXACT, typename T>
__device__ __forceinline__ void load_bp(B2& b, const T* s, int ld, int n0, int k0, int g, int t) {
  const T* p = s + (k0 + 2 * t) * ld + n0 + g;
  split<EXACT>(to_f32(p[0]), b.hi[0], b.lo[0]);
  split<EXACT>(to_f32(p[ld]), b.hi[1], b.lo[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// ---- shared-memory layouts (elements of T unless said), host and device ----

struct Layout {
  int QP, NP;                   // Q and N rounded up to 16
  int ld_xb, ld_bt;             // chunk kernel, ingest blocks: x, B (target 8)
  int ld_cb;                    // chunk kernel, C Bt blocks: C strip, B (target 4)
  int ld_xo, ld_co, ld_so;      // output kernel: x, C (target 4); state (f32, target 8)
  size_t chunk_bytes, out_bytes;
};

template <typename T>
__host__ __device__ inline Layout layout(int Q, int N) {
  Layout l;
  const int es = (int)sizeof(T);
  l.QP = round_up(Q, 16);
  l.NP = round_up(N, 16);
  l.ld_xb = tile_ld(PT, es, 8);
  l.ld_bt = tile_ld(l.NP, es, 8);
  l.ld_cb = tile_ld(l.NP, es, 4);
  l.ld_xo = tile_ld(PT, es, 4);
  l.ld_co = tile_ld(l.NP, es, 4);
  l.ld_so = tile_ld(PT, 4, 8);
  const size_t ingest = (size_t)l.QP * (l.ld_xb + l.ld_bt) * es;
  const size_t cbt = (size_t)(16 + l.QP) * l.ld_cb * es;
  l.chunk_bytes = ingest > cbt ? ingest : cbt;
  l.out_bytes = (size_t)l.QP * (l.ld_xo + l.ld_co) * es + (size_t)l.NP * l.ld_so * 4;
  return l;
}

// ---- kernel 0: misaligned operands packed into aligned rows ----

// Rows that an operand packs into: K = its row (P for x, N for Bm, Cm)
// rounded up to 8 elements (16 bytes in bf16, 32 in f32), zero-padded
__host__ __device__ inline int64_t pack_width(int64_t n) { return (n + 7) / 8 * 8; }

// grid (ceil(rows * K / THREADS) of the largest operand packed, B, 2 or
// 3 with x): z = 0 Bm and z = 1 Cm ((S) rows of N) into (2, B, S, K) rows
// of bcout, z = 2 x ((H, S) rows of P) into (B, H, S, K) rows of xout,
// each when its bit of `pack` is set: one element a thread, every load in
// flight at once
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_pack_kernel(const Args a, int pack, T* xout,
                                                          T* bcout) {
  const int which = blockIdx.z;
  if (!(pack & (which == 2 ? AL_X : which ? AL_C : AL_B))) return;
  const int64_t W = which == 2 ? a.P : a.N, K = pack_width(W);
  const int64_t rows = which == 2 ? a.H * a.S : a.S;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x, b = blockIdx.y;
  if (i >= rows * K) return;
  const int64_t r = i / K, n = i - r * K;
  T v = from_f32<T>(0.f);
  if (n < W) {
    if (which == 2) {
      const int64_t h = r / a.S, s = r - h * a.S;
      v = static_cast<const T*>(a.x)[b * a.xsb + h * a.xsh + s * a.xss + n];
    } else if (which == 1) {
      v = static_cast<const T*>(a.cm)[b * a.csb + r * a.css + n];
    } else {
      v = static_cast<const T*>(a.bm)[b * a.bsb + r * a.bss + n];
    }
  }
  if (which == 2)
    xout[b * rows * K + i] = v;
  else
    bcout[((int64_t)which * a.B + b) * rows * K + i] = v;
}

// ---- kernel 1: the chunks' ingest and cum_last (y < H), C Bt (y >= H) ----

// C Bt of one 16-row strip s of one (b, chunk): warp w computes its column
// tiles w and w + 8 (those with some j <= i)
template <typename T>
__device__ __forceinline__ void cb_block(const Args& a, const Layout& L, T* smem, int64_t b,
                                         int64_t c, int s) {
  constexpr bool EX = sizeof(T) == 2;
  const int Q = (int)a.Q, N = (int)a.N, s0 = (int)(c * a.Q), i0 = 16 * s;
  const int KT = L.QP / 8, jmax = min(2 * s + 1, KT - 1);
  T* sC = smem;               // the strip's 16 rows of C
  T* sB = sC + 16 * L.ld_cb;  // rows 0 .. 16 (jmax + 1) / 2 - 1 of B
  const int brows = 8 * (jmax + 1);
  copy_tile<T>(sC, L.ld_cb, static_cast<const T*>(a.cm) + b * a.csb + (s0 + i0) * a.css, a.css,
               16, Q - i0, L.NP, N);
  copy_tile<T>(sB, L.ld_cb, static_cast<const T*>(a.bm) + b * a.bsb + s0 * a.bss, a.bss,
               brows, Q, L.NP, N);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (warp > jmax) return;
  const bool two = warp + 8 <= jmax;
  float acc[2][4];
  zero(acc);
  for (int k0 = 0; k0 < L.NP; k0 += 8) {
    A4 af;
    load_a<EX>(af, sC, L.ld_cb, 0, k0, g, t);
    B2 bf;
    load_bt<EX>(bf, sB, L.ld_cb, 8 * warp, k0, g, t);
    mma3<EX, EX>(acc[0], af, bf);
    if (two) {
      load_bt<EX>(bf, sB, L.ld_cb, 8 * (warp + 8), k0, g, t);
      mma3<EX, EX>(acc[1], af, bf);
    }
  }
  float4* out = reinterpret_cast<float4*>(a.cb + (b * a.nc + c) * cb_floats(Q)) +
                (int64_t)s * KT * 32 + lane;
  out[warp * 32] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
  if (two) out[(warp + 8) * 32] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
}

template <typename T, typename TD>
__device__ __forceinline__ void ingest_block(const Args& a, const Layout& L, T* smem,
                                             int64_t b, int64_t h, int64_t c, int pt) {
  constexpr bool EX = sizeof(T) == 2;
  __shared__ __align__(16) float s_dt[QMAX], s_cum[QMAX], s_w[QMAX];
  const int Q = (int)a.Q, N = (int)a.N, s0 = (int)(c * a.Q), p0 = pt * PT;
  const int pc = (int)(a.P - p0 < PT ? a.P - p0 : PT);
  T* sX = smem;
  T* sB = sX + L.QP * L.ld_xb;
  copy_tile<T>(sX, L.ld_xb,
               static_cast<const T*>(a.x) + b * a.xsb + h * a.xsh + s0 * a.xss + p0, a.xss,
               L.QP, Q, PT, pc);
  copy_tile<T>(sB, L.ld_bt, static_cast<const T*>(a.bm) + b * a.bsb + s0 * a.bss, a.bss, L.QP,
               Q, L.NP, N);
  cp_commit();
  load_dt(s_dt, static_cast<const TD*>(a.dt) + b * a.dsb + h * a.dsh + s0 * a.dss, a.dss, Q);
  __syncthreads();
  scan_cum(s_cum, s_dt, a.A[h]);
  __syncthreads();
  const float cum_last = s_cum[Q - 1];
  for (int j = threadIdx.x; j < QMAX; j += THREADS)
    s_w[j] = j < Q ? __fmul_rn(expf(__fsub_rn(cum_last, s_cum[j])), s_dt[j]) : 0.f;
  if (pt == 0 && threadIdx.x == 0) a.cl[(b * a.H + h) * a.nc + c] = cum_last;
  cp_wait<0>();
  __syncthreads();

  // ingest[n][p] = sum_j (B[j][n] w_j) x[j][p]: warp w owns rows 16w .. 16w + 15
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = 16 * warp;
  if (n0 >= L.NP) return;
  float acc[PT / 8][4];
  zero(acc);
  const int QK = round_up(Q, 8);
  for (int k0 = 0; k0 < QK; k0 += 8) {
    A4 af;  // A(n, j) = B[j][n] w_j, read transposed
    const T* p = sB + (k0 + t) * L.ld_bt + n0 + g;
    const float w0 = s_w[k0 + t], w1 = s_w[k0 + t + 4];
    split<false>(__fmul_rn(to_f32(p[0]), w0), af.hi[0], af.lo[0]);
    split<false>(__fmul_rn(to_f32(p[8]), w0), af.hi[1], af.lo[1]);
    split<false>(__fmul_rn(to_f32(p[4 * L.ld_bt]), w1), af.hi[2], af.lo[2]);
    split<false>(__fmul_rn(to_f32(p[4 * L.ld_bt + 8]), w1), af.hi[3], af.lo[3]);
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt) {
      B2 bf;
      load_b<EX>(bf, sX, L.ld_xb, 8 * nt, k0, g, t);
      mma3<false, EX>(acc[nt], af, bf);
    }
  }
  const int64_t PP = a.pt * PT;
  float* st = a.states + ((b * a.H + h) * a.nc + c) * a.N * PP + p0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = n0 + g + 8 * hr;
    if (n >= N) continue;
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt)
      *reinterpret_cast<float2*>(st + n * PP + 8 * nt + 2 * t) =
          make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
  }
}

template <typename T, typename TD>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const Layout L = layout<T>((int)a.Q, (int)a.N);
  const int64_t c = blockIdx.x / a.pt, b = blockIdx.z, h = blockIdx.y;
  const int pt = (int)(blockIdx.x % a.pt);
  if (h >= a.H) {
    if (pt == 0) cb_block<T>(a, L, smem, b, c, (int)(h - a.H));
  } else if (c + 1 < a.nc) {  // the last chunk's ingest is never read
    ingest_block<T, TD>(a, L, smem, b, h, c, pt);
  }
}

// ---- kernel 2: the state after each chunk, carried in order ----

__global__ void __launch_bounds__(THREADS) ssd_state_kernel(const Args a) {
  const int64_t per = a.N * a.pt * PT / 4;  // float4s of one (b, h, chunk) state
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x, bh = blockIdx.y;
  if (e >= per) return;
  float4* slot = reinterpret_cast<float4*>(a.states) + bh * a.nc * per + e;
  const float* cl = a.cl + bh * a.nc;
  float4 s = slot[0];  // the state after chunk 0 is its ingest
  for (int64_t c0 = 1; c0 + 1 < a.nc; c0 += STATE_BATCH) {
    float4 v[STATE_BATCH];  // a batch of ingests in flight together
    float d[STATE_BATCH];
#pragma unroll
    for (int u = 0; u < STATE_BATCH; ++u)
      if (c0 + u + 1 < a.nc) {
        v[u] = slot[(c0 + u) * per];
        d[u] = expf(cl[c0 + u]);
      }
#pragma unroll
    for (int u = 0; u < STATE_BATCH; ++u) {  // s <- s exp(cum_last_c) + ingest_c
      if (c0 + u + 1 >= a.nc) break;
      s.x = __fadd_rn(__fmul_rn(s.x, d[u]), v[u].x);
      s.y = __fadd_rn(__fmul_rn(s.y, d[u]), v[u].y);
      s.z = __fadd_rn(__fmul_rn(s.z, d[u]), v[u].z);
      s.w = __fadd_rn(__fmul_rn(s.w, d[u]), v[u].w);
      slot[(c0 + u) * per] = s;
    }
  }
}

// ---- kernel 3: y = exp(cum) (C s) + W x ----

// Warp w takes the column half w / 4 (4 of the 8 column tiles) of the row
// strips sp and QP / 16 - 1 - sp, sp = w % 4: a short causal strip with a
// long one, so every warp has about the same W x work; each B fragment
// of the state serves both strips.
template <typename T, typename TD>
__global__ void __launch_bounds__(THREADS) ssd_out_kernel(const Args a) {
  constexpr bool EX = sizeof(T) == 2;
  constexpr int NT = PT / 16;  // column tiles of a warp
  extern __shared__ float4 smem4[];
  __shared__ __align__(16) float s_dt[QMAX], s_cum[QMAX];
  const Layout L = layout<T>((int)a.Q, (int)a.N);
  const int Q = (int)a.Q, N = (int)a.N;
  const int64_t c = blockIdx.x / a.pt, b = blockIdx.z, h = blockIdx.y;
  const int pt = (int)(blockIdx.x % a.pt), p0 = pt * PT, s0 = (int)(c * a.Q);
  const int pc = (int)(a.P - p0 < PT ? a.P - p0 : PT);
  const int64_t PP = a.pt * PT;
  T* sC = reinterpret_cast<T*>(smem4);
  T* sX = sC + L.QP * L.ld_co;
  float* sS = reinterpret_cast<float*>(sX + L.QP * L.ld_xo);
  const bool carry = c > 0;  // chunk 0 enters with a zero state

  // group 0: C and the state; group 1: x
  copy_tile<T>(sC, L.ld_co, static_cast<const T*>(a.cm) + b * a.csb + s0 * a.css, a.css, L.QP,
               Q, L.NP, N);
  if (carry)  // the state after chunk c - 1
    copy_tile<float>(sS, L.ld_so, a.states + ((b * a.H + h) * a.nc + c - 1) * a.N * PP + p0,
                     PP, L.NP, N, PT, PT);
  cp_commit();
  copy_tile<T>(sX, L.ld_xo,
               static_cast<const T*>(a.x) + b * a.xsb + h * a.xsh + s0 * a.xss + p0, a.xss,
               L.QP, Q, PT, pc);
  cp_commit();
  load_dt(s_dt, static_cast<const TD*>(a.dt) + b * a.dsb + h * a.dsh + s0 * a.dss, a.dss, Q);
  __syncthreads();
  scan_cum(s_cum, s_dt, a.A[h]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nst = L.QP / 16, KT = L.QP / 8, sp = warp & 3, c0 = (warp >> 2) * NT;
  // this warp's strips: sp, and nst - 1 - sp when that is another one (the
  // products run on both slots; a single strip is the same in both)
  const int ns = sp < nst - 1 - sp ? 2 : sp == nst - 1 - sp ? 1 : 0;
  const int strip[2] = {sp, nst - 1 - sp};
  const float4* cbf = reinterpret_cast<const float4*>(a.cb + (b * a.nc + c) * cb_floats(Q)) +
                      lane;
  // the first strip's first C Bt fragment, in flight with the copies
  float4 frag = ns ? cbf[(int64_t)strip[0] * KT * 32] : make_float4(0.f, 0.f, 0.f, 0.f);
  cp_wait<1>();
  __syncthreads();
  if (!ns) {
    cp_wait<0>();
    __syncthreads();
    return;
  }
  float cum_i[2][2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) cum_i[k][hr] = s_cum[min(16 * strip[k] + g + 8 * hr, Q - 1)];

  float acc[2][NT][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) zero(acc[k]);
  if (carry) {  // acc = exp(cum_i) (C s)
    for (int k0 = 0; k0 < L.NP; k0 += 8) {
      A4 af[2];
      load_a<EX>(af[0], sC, L.ld_co, 16 * strip[0], k0, g, t);
      load_a<EX>(af[1], sC, L.ld_co, 16 * strip[1], k0, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        B2 bf;
        load_b<false>(bf, sS, L.ld_so, 8 * (c0 + nt), k0, g, t);
        mma3<EX, false>(acc[0][nt], af[0], bf);
        mma3<EX, false>(acc[1][nt], af[1], bf);  // strip[1] == strip[0] when ns == 1
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float e = expf(cum_i[k][hr]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[k][nt][2 * hr] = __fmul_rn(e, acc[k][nt][2 * hr]);
          acc[k][nt][2 * hr + 1] = __fmul_rn(e, acc[k][nt][2 * hr + 1]);
        }
      }
  }
  cp_wait<0>();
  __syncthreads();

  // acc += W x over each strip's column tiles jt <= 2 strip + 1
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= ns) break;
    const int i0 = 16 * strip[k], jmax = min(2 * strip[k] + 1, KT - 1);
    const float4* sf = cbf + (int64_t)strip[k] * KT * 32;
    if (k == 1) frag = sf[0];
    for (int jt = 0; jt <= jmax; ++jt) {
      const float4 cur = frag;
      if (jt < jmax) frag = sf[(jt + 1) * 32];
      const float cv[4] = {cur.x, cur.y, cur.z, cur.w};
      const int j0 = 8 * jt + 2 * t;
      const float2 cj = *reinterpret_cast<const float2*>(&s_cum[j0]);
      const float2 dj = *reinterpret_cast<const float2*>(&s_dt[j0]);
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
        const int i = i0 + g + 8 * (e >> 1), j = j0 + (e & 1);
        w[e] = 0.f;  // the exponential only where i >= j
        if (i < Q && j <= i)
          w[e] = __fmul_rn(
              __fmul_rn(cv[e], expf(__fsub_rn(cum_i[k][e >> 1], (e & 1) ? cj.y : cj.x))),
              (e & 1) ? dj.y : dj.x);
      }
      A4 af;  // the k index permuted as load_bp reads x's rows
      split<false>(w[0], af.hi[0], af.lo[0]);
      split<false>(w[2], af.hi[1], af.lo[1]);
      split<false>(w[1], af.hi[2], af.lo[2]);
      split<false>(w[3], af.hi[3], af.lo[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        B2 bf;
        load_bp<EX>(bf, sX, L.ld_xo, 8 * (c0 + nt), 8 * jt, g, t);
        mma3<false, EX>(acc[k][nt], af, bf);
      }
    }
  }

  T* y = static_cast<T*>(a.y) + b * a.ysb + h * a.ysh + (int64_t)s0 * a.yss + p0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= ns) break;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = 16 * strip[k] + g + 8 * hr;
      if (i >= Q) continue;
      T* row = y + (int64_t)i * a.yss;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 8 * (c0 + nt) + 2 * t + e;
          if (p < pc) row[p] = from_f32<T>(acc[k][nt][2 * hr + e]);
        }
    }
  }
}

// ---- host side ----

constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

// the 16-byte copy path needs the base pointer and the stride of every
// dimension longer than 1 to be multiples of 16 bytes
bool aligned16(const void* p, int itemsize, std::initializer_list<int64_t> sizes,
               std::initializer_list<int64_t> strides) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  auto n = sizes.begin();
  for (auto s = strides.begin(); s != strides.end(); ++s, ++n)
    if (*n > 1 && (*s * itemsize) % 16) return false;
  return true;
}

// offsets and size in floats, 16-byte aligned; the packed rows (pack: the
// bits of the operands packed) are f32-sized, so either dtype fits
struct Workspace {
  int64_t cb, states, cl, bcpack, xpack, total;
};

Workspace workspace(int64_t B, int64_t H, int64_t S, int64_t P, int64_t N, int64_t Q,
                    int pack) {
  const int64_t nc = S / Q, pt = (P + PT - 1) / PT;
  Workspace w;
  w.cb = 0;
  w.states = B * nc * cb_floats((int)Q);
  w.cl = w.states + B * H * nc * N * pt * PT;
  w.bcpack = w.cl + (B * H * nc + 3) / 4 * 4;
  w.xpack = w.bcpack + ((pack & (AL_B | AL_C)) ? 2 * B * S * pack_width(N) : 0);
  w.total = w.xpack + ((pack & AL_X) ? B * H * S * pack_width(P) : 0);
  return w;
}

bool valid(int64_t B, int64_t H, int64_t S, int64_t P, int64_t N, int64_t Q) {
  return Q >= 1 && Q <= QMAX && S % Q == 0 && N >= 1 && N <= NMAX && B <= 65535 &&
         H + QMAX / 16 <= 65535 && (S / Q) * ((P + PT - 1) / PT) <= 0x7fffffffLL &&
         H * S * pack_width(P) / THREADS < 0x7fffffffLL;
}

// grids, in launch order: pack (a misaligned operand only), chunk, state
// (only with more than two chunks), out
struct Launch {
  dim3 grid[4];
  size_t smem[4];
  bool on[4];
};

template <typename T>
Launch plan(const Args& a, int pack) {
  const Layout L = layout<T>((int)a.Q, (int)a.N);
  Launch l;
  const unsigned gx = (unsigned)(a.nc * a.pt);
  const int64_t packed = std::max((pack & AL_X) ? a.H * a.S * pack_width(a.P) : 0,
                                  (pack & (AL_B | AL_C)) ? a.S * pack_width(a.N) : 0);
  l.grid[0] = dim3((unsigned)((packed + THREADS - 1) / THREADS), (unsigned)a.B,
                   (pack & AL_X) ? 3 : 2);
  l.smem[0] = 0;
  l.on[0] = pack != 0;
  l.grid[1] = dim3(gx, (unsigned)(a.H + L.QP / 16), (unsigned)a.B);
  l.smem[1] = L.chunk_bytes;
  l.on[1] = true;
  l.grid[2] = dim3((unsigned)((a.N * a.pt * PT / 4 + THREADS - 1) / THREADS),
                   (unsigned)(a.B * a.H), 1);
  l.smem[2] = 0;
  l.on[2] = a.nc > 2;
  l.grid[3] = dim3(gx, (unsigned)a.H, (unsigned)a.B);
  l.smem[3] = L.out_bytes;
  l.on[3] = true;
  return l;
}

template <typename K, typename... X>
cudaError_t run(K kernel, dim3 grid, size_t smem, cudaStream_t stream, X... args) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// pack: bits of the operands to pack first (a misaligned view); their
// pointers and strides are then those of the packed rows
template <typename T, typename TD>
cudaError_t launch(Args a, int pack, float* work, const Workspace& w, cudaStream_t stream) {
  const Launch l = plan<T>(a, pack);
  cudaError_t err;
  if (l.on[0]) {
    T* xout = reinterpret_cast<T*>(work + w.xpack);
    T* bcout = reinterpret_cast<T*>(work + w.bcpack);
    err = run(ssd_pack_kernel<T>, l.grid[0], l.smem[0], stream, a, pack, xout, bcout);
    if (err != cudaSuccess) return err;
    if (pack & AL_X) {
      const int64_t K = pack_width(a.P);
      a.x = xout;
      a.xsb = a.H * a.S * K;
      a.xsh = a.S * K;
      a.xss = K;
    }
    const int64_t NK = pack_width(a.N);
    if (pack & AL_B) {
      a.bm = bcout;
      a.bsb = a.S * NK;
      a.bss = NK;
    }
    if (pack & AL_C) {
      a.cm = bcout + a.B * a.S * NK;
      a.csb = a.S * NK;
      a.css = NK;
    }
  }
  err = run(ssd_chunk_kernel<T, TD>, l.grid[1], l.smem[1], stream, a);
  if (err != cudaSuccess) return err;
  if (l.on[2]) {
    err = run(ssd_state_kernel, l.grid[2], l.smem[2], stream, a);
    if (err != cudaSuccess) return err;
  }
  return run(ssd_out_kernel<T, TD>, l.grid[3], l.smem[3], stream, a);
}

Args make_args(int64_t B, int64_t H, int64_t S, int64_t P, int64_t N, int64_t Q) {
  Args a = {};
  a.B = B;
  a.H = H;
  a.S = S;
  a.P = P;
  a.N = N;
  a.Q = Q;
  a.nc = S / Q;
  a.pt = (P + PT - 1) / PT;
  return a;
}

}  // namespace

// dtype (x, Bm, Cm, y) and dt_dtype: 0 float32, 1 bfloat16. Strides are in
// elements; the last axis of x, Bm, Cm and y is dense. chunk (Q) divides S,
// 1 <= Q <= 128 and 1 <= N <= 128. aligned: bit 1 x, 2 Bm, 4 Cm take the
// 16-byte copies (pointer and the strides of dimensions longer than 1 are
// multiples of 16 bytes; a false claim is refused); a misaligned operand
// is first packed into aligned rows of the workspace. work: the f32
// workspace of ssd_scan_workspace floats (for the same aligned), 16-byte
// aligned. Launches the pack (a misaligned operand), chunk, state (more
// than two chunks) and output kernels on the stream. Returns a cudaError_t (0 on success); launches
// nothing for an empty input.
extern "C" int ssd_scan(int dtype, int dt_dtype, int64_t B, int64_t H, int64_t S, int64_t P,
                        int64_t N, int64_t chunk, int aligned, const void* x, int64_t xsb,
                        int64_t xsh, int64_t xss, const void* dt, int64_t dsb, int64_t dsh,
                        int64_t dss, const float* A, const void* bm, int64_t bsb, int64_t bss,
                        const void* cm, int64_t csb, int64_t css, void* y, int64_t ysb,
                        int64_t ysh, int64_t yss, float* work, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0) return 0;
  if (!valid(B, H, S, P, N, chunk) || (dtype != 0 && dtype != 1) ||
      (dt_dtype != 0 && dt_dtype != 1) || reinterpret_cast<uintptr_t>(work) % 16)
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  if (((aligned & AL_X) && !aligned16(x, es, {B, H, S}, {xsb, xsh, xss})) ||
      ((aligned & AL_B) && !aligned16(bm, es, {B, S}, {bsb, bss})) ||
      ((aligned & AL_C) && !aligned16(cm, es, {B, S}, {csb, css})))
    return (int)cudaErrorMisalignedAddress;
  Args a = make_args(B, H, S, P, N, chunk);
  a.x = x;  a.xsb = xsb;  a.xsh = xsh;  a.xss = xss;
  a.dt = dt;  a.dsb = dsb;  a.dsh = dsh;  a.dss = dss;
  a.A = A;
  a.bm = bm;  a.bsb = bsb;  a.bss = bss;
  a.cm = cm;  a.csb = csb;  a.css = css;
  a.y = y;  a.ysb = ysb;  a.ysh = ysh;  a.yss = yss;
  const int pack = ~aligned & (AL_X | AL_B | AL_C);
  const Workspace w = workspace(B, H, S, P, N, chunk, pack);
  a.cb = work + w.cb;
  a.states = work + w.states;
  a.cl = work + w.cl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dt_dtype == 0) return (int)launch<float, float>(a, pack, work, w, st);
  if (dtype == 0 && dt_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(a, pack, work, w, st);
  if (dtype == 1 && dt_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(a, pack, work, w, st);
  return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, pack, work, w, st);
}

// floats of the f32 workspace that ssd_scan needs for these sizes and
// aligned bits (a misaligned operand's packed rows take room)
extern "C" int ssd_scan_workspace(int64_t B, int64_t H, int64_t S, int64_t P, int64_t N,
                                  int64_t chunk, int aligned, int64_t* floats) {
  if (!valid(B, H, S, P, N, chunk)) return (int)cudaErrorInvalidValue;
  *floats = workspace(B, H, S, P, N, chunk, ~aligned & (AL_X | AL_B | AL_C)).total;
  return 0;
}

// The launch configuration of a call: out[0] the CUDA kernels it launches,
// then for the pack, chunk, state and output kernels in turn blocks,
// threads and dynamic shared memory bytes (blocks 0: not launched). aligned
// as for ssd_scan.
extern "C" int ssd_scan_config(int dtype, int64_t B, int64_t H, int64_t S, int64_t P,
                               int64_t N, int64_t chunk, int aligned, int64_t* out) {
  if (!valid(B, H, S, P, N, chunk) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, H, S, P, N, chunk);
  const int pack = ~aligned & (AL_X | AL_B | AL_C);
  const Launch l = dtype == 0 ? plan<float>(a, pack) : plan<__nv_bfloat16>(a, pack);
  out[0] = 0;
  for (int k = 0; k < 4; ++k) {
    const dim3 g = l.grid[k];
    out[0] += l.on[k];
    out[1 + 3 * k] = l.on[k] ? (int64_t)g.x * g.y * g.z : 0;
    out[2 + 3 * k] = THREADS;
    out[3 + 3 * k] = (int64_t)l.smem[k];
  }
  return 0;
}
