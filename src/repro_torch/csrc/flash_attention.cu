// Flash attention, forward and backward, for Hopper (sm_90a), in CUDA C++.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel<float, D>, flash_fwd_bf16_kernel<D>
//       <- flash_attention (_flash_kernel, _flash_kernel_lse)
//   flash_bwd_dq_kernel<float, D>, flash_bwd_dq_bf16_kernel<D>
//       <- flash_attention_bwd, pass 1 (_flash_bwd_dq_kernel)
//   flash_bwd_dkv_kernel<float, D>, flash_bwd_dkv_bf16_kernel<D>
//   (+ flash_dkv_sum_kernel<D> where the bf16 grid is split)
//       <- flash_attention_bwd, pass 2 (_flash_bwd_dkv_kernel)
// and, through the autograd Function in repro_torch/kernels/ops.py, the
// custom_vjp flash_attention_trainable over the two. float32 and bfloat16
// have kernels of their own: the float32 design is described first, the
// bfloat16 one after it.
//
// Function: causal and/or sliding-window GQA attention, q (B,Hq,Sq,D) and
// k, v (B,Hkv,Sk,D), kv head = q head / (Hq/Hkv); online softmax with f32
// running max, sum and accumulator; the forward also writes the f32
// log-sum-exp (B,Hq,Sq) from which the backward recomputes P = exp(s - lse).
// The dq kernel also computes delta = rowsum(do * o) in f32 for its rows
// and writes it to a (B,Hq,Sq) buffer that the dk/dv kernel, launched after
// it on the same stream, reads. Positions are the row indices (query q sees
// key k iff k <= q when causal and q - k < window when window > 0); every
// query row must see a key.
//
// What bounds it on an H100: at the training step's shapes (B=2, H=16,
// S=256, D=64, f32, causal) bytes. The card's f32-accurate matrix rate is
// the tensor cores' TF32 rate over three products (3xTF32, below): 495/3 =
// 165 TFLOP/s. The forward's 0.27 GFLOP over the visible pairs take 1.6 us
// at that rate, its 8.4 MB of q, k, v, o and lse 2.5 us at 3.35 TB/s; the
// backward's 0.67 GFLOP take 4.1 us, its 16.8 MB 5.0 us. Measured on an
// NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, PERF.md): forward 24 us,
// backward 75 us, 10x and 15x those bounds, against 33 us and 81 us for
// PyTorch's f32 scaled_dot_product_attention.
//
// What the design does about it:
// * Every product runs on the tensor cores: mma.sync m16n8k8 TF32 with f32
//   accumulators, in 3xTF32 for f32 operands. x = hi + lo with hi =
//   cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi); a.b ~ lo_a.hi_b +
//   hi_a.lo_b + hi_a.hi_b, the small terms first: within ~1e-6 of f32, where
//   one TF32 product is off by ~5e-4. bf16 values are exact in TF32 (lo = 0),
//   so a product of two bf16 operands takes one mma and one of P or dS (f32)
//   with a bf16 operand two; P and dS are never rounded to bf16.
// * P and dS stay in registers: the accumulator fragment of m16n8k8 holds
//   columns (2t, 2t+1) of a row, the A operand wants (t, t+4); the key index
//   is summed over, so the B operand (V, K, Q or dO) is read with keys in
//   the order 2t, 2t+1 instead of shuffling P between lanes.
// * Tiles of 64 rows come in by 16-byte cp.async.cg copies into a ring of 2
//   stages in shared memory: the next K/V (in dk/dv, Q/dO/lse/delta) tile is
//   in flight while the current one is multiplied. Rows past the end are
//   zero-filled by the copy (source size 0). Rows are padded by 16 bytes,
//   which makes every fragment load free of bank conflicts. An operand whose
//   pointer or strides are not 16-byte aligned (the wrapper says which, and
//   the launcher checks it) is copied element by element into the same ring
//   inside the same kernel: no copy of the tensor, no other kernel.
// * Latency, not rate, held the first design (one warpgroup a block) at
//   SDPA's speed: at the step's shape each grid is 128 blocks, one warp an
//   SM sub-partition, and the last query tile walks 4 key tiles. So a block
//   holds two warpgroups of 4 warps (16 rows a warp) that take alternate
//   key tiles (dk/dv: alternate (head, query tile) iterations) from a ring
//   of 2 stages x 2 slots, and merge at the end through shared memory:
//   (m, l, acc) in the forward, plain sums in the backward. That halves the
//   chain and doubles the warps; it beat one warpgroup in an A/B on the
//   card (PERF.md). 153-172 KB of shared memory a block at D=64 f32, so one
//   block an SM: 8 warps, where the 2 blocks of 4 warps the first design
//   aimed at would each still walk the whole chain. f32 D=128, whose ring
//   would not fit, keeps one warpgroup. The forward and dq grids take the last query tile, the
//   longest causal chain, first; in dk/dv the first key tile is the
//   longest and already comes first.
// * Tiles that the causal mask or the window hides entirely are skipped
//   (the Pallas grid visits and masks them); that computes the same
//   function.
// * A deterministic backward with no atomics: each dq block owns its query
//   rows; the dk/dv block owns one key tile of one kv head and loops over the
//   G query heads of its group, so the group sum the reference does outside
//   its kernel happens in f32 registers, in a fixed order; the warpgroups'
//   partial sums add in a fixed order too.
// * Any strides for the batch, head and sequence dimensions (the last
//   dimension must be dense): the decoder's (B,S,H,D) tensors go in as
//   (B,H,S,D) views without a copy.
// Left for later work: wgmma (its .tf32 form reads only K-major operands
// from shared memory, so V, Q, dO and dS would need a transpose) and TMA.
//
// bfloat16 (the MoE, hybrid, VLM and encoder-decoder families): what bounds
// it at Whisper's encoder shape (B=2, H=20, S=1500, D=64, not causal) is
// operations: the forward's 23 GFLOP take 23 us at the bf16 tensor rate
// (989 TFLOP/s), its 31 MB 9 us at 3.35 TB/s; at the 256-row causal steps
// (Whisper's decoder, and D=128 on 2-8 KV heads) bytes, 1-3 us, and the
// latency of a chain of at most 4 key tiles.
// The TF32 route of the float32 kernels cost bf16 half the tensor rate, a
// scalar shared load and conversion an element of every fragment, and a
// dk/dv grid of B·Hkv·Sk/64 blocks: 16 on 132 SMs at Qwen2-VL's 2 KV heads
// (2.4-9.0x PyTorch's SDPA, PERF.md). What the bf16 design does:
// * Every product is mma.sync m16n8k16 on bf16 operands, f32 accumulators
//   (2048 multiply-adds an instruction, at the bf16 rate). Q·Kᵀ and dO·Vᵀ
//   take one product (bf16 x bf16 is exact in f32). P and dS are f32 and
//   are never rounded to one bf16 term, as the reference keeps them f32: x
//   = hi + lo, hi = bf16(x), lo = bf16(x - hi) (16 of x's bits), and
//   lo·X, then hi·X; one term fails chip_smoke.py's o gate where o is near
//   0 (tests/test_torch_flash_attention.py holds both on the CPU).
// * Fragments come by ldmatrix.x4 from the padded tiles (rows 16 bytes
//   apart in banks: conflict-free): A and the B of A·Xᵀ as stored, the B
//   of P·X (V, K, dO, Q: the summed index along the tile's rows) with
//   .trans. P and dS go from the accumulator layout to the A layout in
//   registers: the accumulator's columns 2t, 2t+1 of a 16 x 8 tile pack to
//   one bf16 pair, which is the A register of k 2t, 2t+1 (n-tiles 2j and
//   2j+1 give the k halves 0-7 and 8-15), so no operand is permuted.
// * The softmax runs in base 2 (ex2.approx: one MUFU.EX2) on scores
//   scaled by scale·log2(e) in the same FMA that subtracts the row max; a
//   warp applies the causal/window/edge mask only on the tiles it does not
//   see whole (all_seen), branch-free (seen).
// * The backward never holds a 16 x 64 score tile: a warp keeps one
//   operand's fragments (Q in dq; K in dk/dv at D <= 64) and walks the
//   tile 16 columns at a time: scores and dP of 16 columns, P and dS, then
//   their products into dq (or dk and dv). That kept every kernel below
//   its register cap without spills (ptxas, chip_smoke.py phase ptxas).
// * Shared memory is half the f32 kernels' (a 64-row tile 9.2 KB at D=64,
//   17.4 KB at D=128): the same 2 warpgroups and 2-stage cp.async ring;
//   at D <= 64 the forward and dq blocks ask for 2 blocks an SM
//   (__launch_bounds__(256, 2): at most 128 registers a thread), dk/dv
//   (two f32 accumulators of 16 x D) and every D=128 kernel for one.
// * The grids take the query (dk/dv: key) tile as their slowest index, the
//   longest causal chain first, so every head's longest blocks start in
//   the first wave.
// * The dq kernel loads o as a tile too and takes delta from shared memory;
//   the dk/dv kernel is launched as its programmatic dependent (PDL): its
//   K and V copies start while dq finishes, and griddepcontrol.wait holds
//   its first read of delta until the dq grid is done.
// * The dk/dv grid fills the card under GQA: where B·Hkv·ceil(Sk/64) blocks
//   leave SMs idle, each key tile's G·nq (query head, query tile)
//   iterations are cut into nsplit contiguous parts (kernels/
//   flash_attention.py::dkv_split, a function of the shape and the SM
//   count), folded into the grid's x dimension; each part writes f32
//   partial dk and dv, and flash_dkv_sum_kernel adds them in part order
//   and rounds once: deterministic, no atomics.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): #4 at 0.25-
// 0.46x the TF32 route's time at the bf16 families' shapes, 1.2-2.9x
// SDPA's. Left for later work: wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows of a tile
constexpr int BK = 64;   // key rows of a tile
constexpr int WG = 128;  // threads of a warpgroup: 4 warps x 16 rows
constexpr float NEG_INF = -1e30f;

// bits of Params::aligned: the operand takes 16-byte asynchronous copies
constexpr int AL_Q = 1, AL_K = 2, AL_V = 4, AL_DO = 8;

struct View {  // one (B, H, S, D) tensor: base pointer and element strides
  void* p;
  int64_t sb, sh, ss;
};

struct Params {
  View q, k, v, dout, o, dq, dk, dv;
  float* lse;
  float* delta;
  int B, Hq, Hkv, Sq, Sk, causal, window, aligned;
  float scale;
};

template <typename T> __host__ __device__ constexpr int row_stride(int D) {
  return D + 16 / (int)sizeof(T);
}
template <typename T> __host__ __device__ constexpr size_t tile_bytes(int D) {
  return (size_t)64 * row_stride<T>(D) * sizeof(T);
}

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

// ---- asynchronous copies ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows of a (S, D) slice with row stride ss into shared memory (row
// stride row_stride<T>(D)); rows at or past nrows become zeros. vec: 16-byte
// cp.async copies (pointer and stride aligned), else element by element.
template <typename T, int D>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int64_t ss, int row0, int nrows,
                                          bool vec) {
  constexpr int LD = row_stride<T>(D);
  if (vec) {
    constexpr int E = 16 / sizeof(T), CPR = D / E;  // elements a copy, copies a row
    for (int idx = threadIdx.x; idx < 64 * CPR; idx += blockDim.x) {
      const int r = idx / CPR, c = (idx - r * CPR) * E, gr = row0 + r;
      const bool in = gr < nrows;
      cp_async16(dst + r * LD + c, in ? src + (int64_t)gr * ss + c : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * D; idx += blockDim.x) {
      const int r = idx / D, c = idx - r * D, gr = row0 + r;
      dst[r * LD + c] = gr < nrows ? src[(int64_t)gr * ss + c] : from_f32<T>(0.f);
    }
  }
}

// ---- tensor-core products in 3xTF32 ----

struct A4 { uint32_t hi[4], lo[4]; };  // A fragment of m16n8k8, split
struct B2 { uint32_t hi[2], lo[2]; };  // B fragment

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32; EXACT: x is a bf16 value, exact in TF32, lo = 0
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
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

// A = rows r0.. r0+15, columns k0.. k0+7 of a row-major tile
template <bool EXACT, typename T>
__device__ __forceinline__ void load_a(A4& a, const T* s, int ld, int r0, int k0, int g, int t) {
  const T* p = s + (r0 + g) * ld + k0 + t;
  split<EXACT>(to_f32(p[0]), a.hi[0], a.lo[0]);
  split<EXACT>(to_f32(p[8 * ld]), a.hi[1], a.lo[1]);
  split<EXACT>(to_f32(p[4]), a.hi[2], a.lo[2]);
  split<EXACT>(to_f32(p[8 * ld + 4]), a.hi[3], a.lo[3]);
}

// B of A.Xᵀ, X a row-major [n][k] tile: (k, n) = X[n0 + n][k0 + k]
template <bool EXACT, typename T>
__device__ __forceinline__ void load_bt(B2& b, const T* s, int ld, int n0, int k0, int g, int t) {
  const T* p = s + (n0 + g) * ld + k0 + t;
  split<EXACT>(to_f32(p[0]), b.hi[0], b.lo[0]);
  split<EXACT>(to_f32(p[4]), b.hi[1], b.lo[1]);
}

// B of P.X, X a row-major [k][n] tile, with the k index in the order of
// a_from_acc: k = t reads row k0 + 2t, k = t + 4 reads row k0 + 2t + 1
template <bool EXACT, typename T>
__device__ __forceinline__ void load_bp(B2& b, const T* s, int ld, int n0, int k0, int g, int t) {
  const T* p = s + (k0 + 2 * t) * ld + n0 + g;
  split<EXACT>(to_f32(p[0]), b.hi[0], b.lo[0]);
  split<EXACT>(to_f32(p[ld]), b.hi[1], b.lo[1]);
}

// A from an accumulator tile (P or dS), its k index permuted as load_bp
// reads: (g, t) <- (g, 2t), (g+8, t) <- (g+8, 2t), (g, t+4) <- (g, 2t+1)
__device__ __forceinline__ void a_from_acc(A4& a, const float (&c)[4]) {
  split<false>(c[0], a.hi[0], a.lo[0]);
  split<false>(c[2], a.hi[1], a.lo[1]);
  split<false>(c[1], a.hi[2], a.lo[2]);
  split<false>(c[3], a.hi[3], a.lo[3]);
}

// acc[j] += A[r0.., :] . B[8j.., :]ᵀ over D: a 16 x 64 score tile of a warp
template <bool EXACT, typename T, int D>
__device__ __forceinline__ void tile_abt(float (&acc)[8][4], const T* A, const T* B, int r0,
                                         int g, int t) {
  constexpr int LD = row_stride<T>(D);
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) {
    A4 a;
    load_a<EXACT>(a, A, LD, r0, 8 * kc, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      B2 b;
      load_bt<EXACT>(b, B, LD, 8 * j, 8 * kc, g, t);
      mma3<EXACT, EXACT>(acc[j], a, b);
    }
  }
}

// acc[n] += P . X[:, 8n..]: P a warp's 16 x 64 tile in accumulator
// fragments, X a row-major 64 x D tile
template <bool EXACT, typename T, int D>
__device__ __forceinline__ void tile_pv(float (&acc)[D / 8][4], const float (&P)[8][4],
                                        const T* X, int g, int t) {
  constexpr int LD = row_stride<T>(D);
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    A4 a;
    a_from_acc(a, P[kc]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      B2 b;
      load_bp<EXACT>(b, X, LD, 8 * n, 8 * kc, g, t);
      mma3<false, EXACT>(acc[n], a, b);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// reductions over the 4 lanes of a quad (one row of a fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows r0 + g and r0 + g + 8 of a (S, D) slice from acc * mul; rows at or
// past nrows are not written
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int64_t ss, int row0, int nrows,
                                           const float (&acc)[D / 8][4], float mul, int g,
                                           int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + g + 8 * hr;
    if (r >= nrows) continue;
    T* row = dst + (int64_t)r * ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      row[8 * n] = from_f32<T>(acc[n][2 * hr] * mul);
      row[8 * n + 1] = from_f32<T>(acc[n][2 * hr + 1] * mul);
    }
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

// Warpgroup 1 of a split block hands its fragments to warpgroup 0 through
// shared memory in fragment order: conflict-free, and both warpgroups hold
// the same (row, column) in the same lane and register. buf: the warp's
// region.
template <int N>
__device__ __forceinline__ void stash(float* buf, const float (&x)[N][4], int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) buf[(4 * i + e) * 32 + lane] = x[i][e];
}
template <int N>
__device__ __forceinline__ void add_stash(float (&x)[N][4], const float* buf, int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] += buf[(4 * i + e) * 32 + lane];
}

// grid (ceil(Sq/64), Hq, B), SPLIT warpgroups: o and lse of one query tile
// of one head. Warpgroup w takes key tiles w, w + SPLIT, ...; the partial
// softmax states (m, l, acc) merge at the end.
template <typename T, int D, int SPLIT>
__global__ void __launch_bounds__(WG * SPLIT) flash_fwd_kernel(const Params p) {
  constexpr int TILE = 64 * row_stride<T>(D), NN = D / 8;
  constexpr bool EX = sizeof(T) == 2;  // bf16: exact in TF32
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* ring = sQ + TILE;  // round r: K, V of key tile r SPLIT + w in slot SPLIT (r & 1) + w
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal chain first
  const int hk = h / (p.Hq / p.Hkv);
  const int wg = threadIdx.x / WG, wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wi * 16;
  const T* k = slice<T>(p.k, b, hk);
  const T* v = slice<T>(p.v, b, hk);
  int k_begin, k_end;
  key_range(p, q0, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int n_rounds = (n_tiles + SPLIT - 1) / SPLIT;
  auto issue = [&](int r) {  // round r's K/V tiles into its stage
#pragma unroll
    for (int w = 0; w < SPLIT; ++w) {
      if (r * SPLIT + w >= n_tiles) break;
      const int kt = k_begin + (r * SPLIT + w) * BK;
      T* dst = ring + 2 * (SPLIT * (r & 1) + w) * TILE;
      copy_tile<T, D>(dst, k, p.k.ss, kt, p.Sk, p.aligned & AL_K);
      copy_tile<T, D>(dst + TILE, v, p.v.ss, kt, p.Sk, p.aligned & AL_V);
    }
  };

  copy_tile<T, D>(sQ, slice<T>(p.q, b, h), p.q.ss, q0, p.Sq, p.aligned & AL_Q);
  issue(0);
  cp_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NN][4];
  zero(acc);
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) issue(r + 1);  // in flight while this round is multiplied
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int i = r * SPLIT + wg;
    if (i < n_tiles) {
      const int k0 = k_begin + i * BK;
      const T* sK = ring + 2 * (SPLIT * (r & 1) + wg) * TILE;
      float s[8][4];
      zero(s);
      tile_abt<EX, T, D>(s, sQ, sK, r0, g, t);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qi = q0 + r0 + g + 8 * hr;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * hr + e];
            x = visible(p, qi, k0 + 8 * j + 2 * t + e) ? x * p.scale : NEG_INF;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m[hr], quad_max(mx));
        const float corr = expf(m[hr] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * hr + e];
            x = expf(x - m_new);
            rs += x;
          }
        l[hr] = l[hr] * corr + quad_sum(rs);
        m[hr] = m_new;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          acc[n][2 * hr] *= corr;
          acc[n][2 * hr + 1] *= corr;
        }
      }
      tile_pv<EX, T, D>(acc, s, sK + TILE, g, t);
    }
    __syncthreads();  // this stage is refilled by the next round
  }

  if (SPLIT > 1) {  // the ring is free: warpgroup 1's state joins warpgroup 0's
    float* buf = reinterpret_cast<float*>(ring) + wi * (16 * D + 128);
    float* ml = buf + 16 * D;  // m of rows g, g + 8; then l
    if (wg == 1) {
      stash(buf, acc, lane);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        ml[32 * hr + lane] = m[hr];
        ml[64 + 32 * hr + lane] = l[hr];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m1 = ml[32 * hr + lane], l1 = ml[64 + 32 * hr + lane];
      const float m_new = fmaxf(m[hr], m1);
      const float c0 = expf(m[hr] - m_new), c1 = expf(m1 - m_new);
      m[hr] = m_new;
      l[hr] = l[hr] * c0 + l1 * c1;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * hr + e;
          acc[n][x] = acc[n][x] * c0 + buf[(4 * n + x) * 32 + lane] * c1;
        }
    }
  }

  T* o = slice<T>(p.o, b, h);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    T* row = o + (int64_t)qi * p.o.ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      row[8 * n] = from_f32<T>(acc[n][2 * hr] / den);
      row[8 * n + 1] = from_f32<T>(acc[n][2 * hr + 1] / den);
    }
    if (t == 0) p.lse[((int64_t)b * p.Hq + h) * p.Sq + qi] = m[hr] + logf(den);
  }
}

// grid (ceil(Sq/64), Hq, B), SPLIT warpgroups: delta = rowsum(do * o) and dq
// of one query tile of one head. Warpgroup w takes key tiles w, w + SPLIT,
// ...; the partial dq sum in a fixed order at the end.
template <typename T, int D, int SPLIT>
__global__ void __launch_bounds__(WG * SPLIT) flash_bwd_dq_kernel(const Params p) {
  constexpr int TILE = 64 * row_stride<T>(D), NN = D / 8;
  constexpr bool EX = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sDO = sQ + TILE;
  T* ring = sDO + TILE;  // round r: K, V of key tile r SPLIT + w in slot SPLIT (r & 1) + w
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int wg = threadIdx.x / WG, wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wi * 16;
  const T* k = slice<T>(p.k, b, hk);
  const T* v = slice<T>(p.v, b, hk);
  const T* dout = slice<T>(p.dout, b, h);
  int k_begin, k_end;
  key_range(p, q0, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int n_rounds = (n_tiles + SPLIT - 1) / SPLIT;
  auto issue = [&](int r) {
#pragma unroll
    for (int w = 0; w < SPLIT; ++w) {
      if (r * SPLIT + w >= n_tiles) break;
      const int kt = k_begin + (r * SPLIT + w) * BK;
      T* dst = ring + 2 * (SPLIT * (r & 1) + w) * TILE;
      copy_tile<T, D>(dst, k, p.k.ss, kt, p.Sk, p.aligned & AL_K);
      copy_tile<T, D>(dst + TILE, v, p.v.ss, kt, p.Sk, p.aligned & AL_V);
    }
  };

  copy_tile<T, D>(sQ, slice<T>(p.q, b, h), p.q.ss, q0, p.Sq, p.aligned & AL_Q);
  copy_tile<T, D>(sDO, dout, p.dout.ss, q0, p.Sq, p.aligned & AL_DO);
  issue(0);
  cp_commit();

  // delta of the warp's 16 rows from o and do in device memory, while the
  // copies fly; warpgroup 0 writes it for the dk/dv kernel
  const T* o = slice<T>(p.o, b, h);
  const int64_t row0 = ((int64_t)b * p.Hq + h) * p.Sq;
  float lse[2], delta[2] = {0.f, 0.f};
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int qi = q0 + r0 + i;
    float d = 0.f;
    if (qi < p.Sq) {
#pragma unroll
      for (int c = lane; c < D; c += 32)
        d = fmaf(to_f32(dout[(int64_t)qi * p.dout.ss + c]), to_f32(o[(int64_t)qi * p.o.ss + c]), d);
    }
    d = warp_sum(d);
    if (i == g) delta[0] = d;
    if (i == g + 8) delta[1] = d;
    if (wg == 0 && lane == 0 && qi < p.Sq) p.delta[row0 + qi] = d;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    lse[hr] = qi < p.Sq ? p.lse[row0 + qi] : 0.f;
  }

  float acc[NN][4];
  zero(acc);
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) issue(r + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int i = r * SPLIT + wg;
    if (i < n_tiles) {
      const int k0 = k_begin + i * BK;
      const T* sK = ring + 2 * (SPLIT * (r & 1) + wg) * TILE;
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      tile_abt<EX, T, D>(s, sQ, sK, r0, g, t);
      tile_abt<EX, T, D>(dp, sDO, sK + TILE, r0, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // e: (row g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
          const int hr = e >> 1, qi = q0 + r0 + g + 8 * hr, kj = k0 + 8 * j + 2 * t + (e & 1);
          const float pv = visible(p, qi, kj) ? expf(s[j][e] * p.scale - lse[hr]) : 0.f;
          s[j][e] = pv * (dp[j][e] - delta[hr]);  // dS
        }
      tile_pv<EX, T, D>(acc, s, sK, g, t);
    }
    __syncthreads();
  }

  if (SPLIT > 1) {
    float* buf = reinterpret_cast<float*>(ring) + wi * 16 * D;
    if (wg == 1) stash(buf, acc, lane);
    __syncthreads();
    if (wg == 1) return;
    add_stash(acc, buf, lane);
  }
  store_rows<T, D>(slice<T>(p.dq, b, h), p.dq.ss, q0 + r0, p.Sq, acc, p.scale, g, t);
}

// grid (ceil(Sk/64), Hkv, B), SPLIT warpgroups: dk and dv of one key tile of
// one kv head, summed over the G query heads of its group. The (head, query
// tile) iterations go round the warpgroups; their partial sums add in a
// fixed order at the end.
template <typename T, int D, int SPLIT>
__global__ void __launch_bounds__(WG * SPLIT) flash_bwd_dkv_kernel(const Params p) {
  constexpr int TILE = 64 * row_stride<T>(D), NN = D / 8;
  constexpr bool EX = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);
  T* sV = sK + TILE;
  T* ring = sV + TILE;  // slot s: Q at ring + 2s TILE, dO after it
  float* ring_f = reinterpret_cast<float*>(ring + 4 * SPLIT * TILE);  // slot s: lse, delta
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BK;  // key tile 0 is the longest
  const int G = p.Hq / p.Hkv;
  const int wg = threadIdx.x / WG, wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wi * 16;
  int q_begin, q_end;
  query_range(p, k0, q_begin, q_end);
  const int nq = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_iter = G * nq;
  const int n_rounds = (n_iter + SPLIT - 1) / SPLIT;

  // iteration it: query head hk G + it / nq, query tile q_begin + (it % nq) BQ
  auto issue = [&](int r) {
#pragma unroll
    for (int w = 0; w < SPLIT; ++w) {
      const int it = r * SPLIT + w;
      if (it >= n_iter) break;
      const int h = hk * G + it / nq, q0 = q_begin + (it % nq) * BQ, slot = SPLIT * (r & 1) + w;
      T* dst = ring + 2 * slot * TILE;
      copy_tile<T, D>(dst, slice<T>(p.q, b, h), p.q.ss, q0, p.Sq, p.aligned & AL_Q);
      copy_tile<T, D>(dst + TILE, slice<T>(p.dout, b, h), p.dout.ss, q0, p.Sq,
                      p.aligned & AL_DO);
      const int64_t row0 = ((int64_t)b * p.Hq + h) * p.Sq;
      for (int idx = threadIdx.x; idx < 2 * BQ; idx += blockDim.x) {
        const float* src = idx < BQ ? p.lse : p.delta;
        const int rq = q0 + (idx & (BQ - 1));
        const bool in = rq < p.Sq;
        cp_async4(ring_f + 2 * BQ * slot + idx, in ? src + row0 + rq : src, in ? 4 : 0);
      }
    }
  };

  copy_tile<T, D>(sK, slice<T>(p.k, b, hk), p.k.ss, k0, p.Sk, p.aligned & AL_K);
  copy_tile<T, D>(sV, slice<T>(p.v, b, hk), p.v.ss, k0, p.Sk, p.aligned & AL_V);
  issue(0);
  cp_commit();

  float acc_k[NN][4], acc_v[NN][4];
  zero(acc_k);
  zero(acc_v);
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) issue(r + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int it = r * SPLIT + wg;
    if (it < n_iter) {
      const int q0 = q_begin + (it % nq) * BQ, slot = SPLIT * (r & 1) + wg;
      const T* sQ = ring + 2 * slot * TILE;
      const T* sDO = sQ + TILE;
      const float* sL = ring_f + 2 * BQ * slot;
      const float* sDelta = sL + BQ;
      float s[8][4], dp[8][4];  // [j][e]: key row r0 + g (+8), query column 8j + 2t (+1)
      zero(s);
      zero(dp);
      tile_abt<EX, T, D>(s, sK, sQ, r0, g, t);
      tile_abt<EX, T, D>(dp, sV, sDO, r0, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = k0 + r0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          const float pv = visible(p, q0 + c, ki) ? expf(s[j][e] * p.scale - sL[c]) : 0.f;
          s[j][e] = pv;                            // Pᵀ
          dp[j][e] = pv * (dp[j][e] - sDelta[c]);  // dSᵀ
        }
      tile_pv<EX, T, D>(acc_v, s, sDO, g, t);
      tile_pv<EX, T, D>(acc_k, dp, sQ, g, t);
    }
    __syncthreads();
  }
  cp_wait<0>();

  if (SPLIT > 1) {
    float* buf = reinterpret_cast<float*>(ring) + wi * 32 * D;
    if (wg == 1) {
      stash(buf, acc_k, lane);
      stash(buf + 16 * D, acc_v, lane);
    }
    __syncthreads();
    if (wg == 1) return;
    add_stash(acc_k, buf, lane);
    add_stash(acc_v, buf + 16 * D, lane);
  }
  store_rows<T, D>(slice<T>(p.dk, b, hk), p.dk.ss, k0 + r0, p.Sk, acc_k, p.scale, g, t);
  store_rows<T, D>(slice<T>(p.dv, b, hk), p.dv.ss, k0 + r0, p.Sk, acc_v, 1.f, g, t);
}

// ---- bf16: mma.sync m16n8k16 fed by ldmatrix ----

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// Four 8x8 b16 matrices from shared memory: lanes 8i .. 8i+7 give the row
// addresses of matrix i; register i of lane (g, t) holds its row g,
// elements 2t and 2t+1 (the lower in the low half).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// the same, each matrix transposed: register i holds rows 2t and 2t+1 of
// column g
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a.b over k = 16: A (g, 2t..2t+1), (g+8, ..), (g, 2t+8..), (g+8, 2t+8..)
// in its four registers; B (k 2t..2t+1, n g), (k 2t+8.., n g) in its two
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as a bf16 pair, x0 in the low half
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}
// x = hi + lo, each a bf16 pair: lo = bf16(x - hi) keeps the next 8 bits,
// about 16 of x's mantissa in all
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2(x0, x1);
  lo = pack2(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// A = rows r0.. r0+15, columns k0.. k0+15 of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld, int r0, int k0,
                                       int lane) {
  ldsm4(a, s + (r0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}
// B of A.Xᵀ over k0.. k0+15, X a row-major [n][k] tile: b[0], b[1] of the
// n-block n0, b[2], b[3] of n0 + 8
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0,
                                        int lane) {
  ldsm4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3));
}
// B of P.X over k0.. k0+15, X a row-major [k][n] tile: b[0], b[1] of the
// n-block n0, b[2], b[3] of n0 + 8
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0,
                                       int lane) {
  ldsm4t(b, s + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
}

// acc[j] += A[r0.., :] . X[8j.., :]ᵀ over D: a 16 x 64 score tile of a
// warp; both operands bf16, one product each
template <int D>
__device__ __forceinline__ void bf_abt(float (&acc)[8][4], const bf16* A, const bf16* X, int r0,
                                       int lane) {
  constexpr int LD = row_stride<bf16>(D);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    frag_a(a, A, LD, r0, 16 * kc, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      frag_bt(b, X, LD, 16 * j, 16 * kc, lane);
      mma16(acc[2 * j], a, b[0], b[1]);
      mma16(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// a[kc]: the A fragments of rows r0.. r0+15 of a row-major 64 x D tile,
// columns 16kc.. 16kc+15: a warp's rows over the whole D
template <int D>
__device__ __forceinline__ void frags_a(uint32_t (&a)[D / 16][4], const bf16* s, int r0,
                                        int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) frag_a(a[kc], s, row_stride<bf16>(D), r0, 16 * kc, lane);
}

// acc[0], acc[1] += A . X[n0.. n0+15, :]ᵀ over D: a warp's 16 x 16 block of
// scores, A in fragments (frags_a)
template <int D>
__device__ __forceinline__ void bf_abt16(float (&acc)[2][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* X, int n0, int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t b[4];
    frag_bt(b, X, row_stride<bf16>(D), n0, 16 * kc, lane);
    mma16(acc[0], a[kc], b[0], b[1]);
    mma16(acc[1], a[kc], b[2], b[3]);
  }
}

// acc[n] += P . X[k0.. k0+15, 8n..]: P a warp's 16 x 16 f32 block in the
// accumulator fragments of two 16 x 8 tiles, whose columns 2t, 2t+1 pack
// to a bf16 pair in the A layout, split in two terms (lo.X, then hi.X); X
// a row-major 64 x D bf16 tile
template <int D>
__device__ __forceinline__ void bf_pv16(float (&acc)[D / 8][4], const float (&P)[2][4],
                                        const bf16* X, int k0, int lane) {
  uint32_t hi[4], lo[4];
  split2(P[0][0], P[0][1], hi[0], lo[0]);
  split2(P[0][2], P[0][3], hi[1], lo[1]);
  split2(P[1][0], P[1][1], hi[2], lo[2]);
  split2(P[1][2], P[1][3], hi[3], lo[3]);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    uint32_t b[4];
    frag_b(b, X, row_stride<bf16>(D), k0, 16 * n, lane);
    mma16(acc[2 * n], lo, b[0], b[1]);
    mma16(acc[2 * n + 1], lo, b[2], b[3]);
    mma16(acc[2 * n], hi, b[0], b[1]);
    mma16(acc[2 * n + 1], hi, b[2], b[3]);
  }
}

// acc[n] += P . X[:, 8n..] over a warp's 16 x 64 f32 tile P
template <int D>
__device__ __forceinline__ void bf_pv(float (&acc)[D / 8][4], const float (&P)[8][4],
                                      const bf16* X, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    bf_pv16<D>(acc, *reinterpret_cast<const float(*)[2][4]>(&P[2 * kc]), X, 16 * kc, lane);
}

// 2^x in one MUFU.EX2 (a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// visible() without branches
__device__ __forceinline__ bool seen(const Params& p, int q, int k) {
  return (q < p.Sq) & (k < p.Sk) & (!p.causal | (k <= q)) &
         ((p.window <= 0) | (q - k < p.window));
}

// programmatic dependent launch: the next kernel on the stream may start
// once every block of this one has called allow_next_grid (or exited);
// wait_prior_grid returns when the kernel before has finished and its
// writes are visible (at once where there is none to wait for)
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// every pair of queries q0 .. q0+nq-1 and keys k0 .. k0+nk-1 is visible
__device__ __forceinline__ bool all_seen(const Params& p, int q0, int nq, int k0, int nk) {
  return q0 + nq <= p.Sq && k0 + nk <= p.Sk && (!p.causal || k0 + nk - 1 <= q0) &&
         (p.window <= 0 || q0 + nq - 1 - k0 < p.window);
}

// grid (Hq, B, ceil(Sq/64)), SPLIT warpgroups: as flash_fwd_kernel, on
// bf16 products; the softmax runs in base 2 on scores scaled by
// scale·log2(e). The query tile is the slowest grid index, the last tile
// first: every head's longest causal chain is dispatched before any
// shorter one.
template <int D, int SPLIT, int MINB>
__global__ void __launch_bounds__(WG * SPLIT, MINB) flash_fwd_bf16_kernel(const Params p) {
  constexpr int TILE = 64 * row_stride<bf16>(D), NN = D / 8;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* ring = sQ + TILE;  // round r: K, V of key tile r SPLIT + w in slot SPLIT (r & 1) + w
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the longest causal chain first
  const int hk = h / (p.Hq / p.Hkv);
  const int wg = threadIdx.x / WG, wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wi * 16;
  const float sl2 = p.scale * LOG2E;
  const bf16* k = slice<bf16>(p.k, b, hk);
  const bf16* v = slice<bf16>(p.v, b, hk);
  int k_begin, k_end;
  key_range(p, q0, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int n_rounds = (n_tiles + SPLIT - 1) / SPLIT;
  auto issue = [&](int r) {
#pragma unroll
    for (int w = 0; w < SPLIT; ++w) {
      if (r * SPLIT + w >= n_tiles) break;
      const int kt = k_begin + (r * SPLIT + w) * BK;
      bf16* dst = ring + 2 * (SPLIT * (r & 1) + w) * TILE;
      copy_tile<bf16, D>(dst, k, p.k.ss, kt, p.Sk, p.aligned & AL_K);
      copy_tile<bf16, D>(dst + TILE, v, p.v.ss, kt, p.Sk, p.aligned & AL_V);
    }
  };

  copy_tile<bf16, D>(sQ, slice<bf16>(p.q, b, h), p.q.ss, q0, p.Sq, p.aligned & AL_Q);
  issue(0);
  cp_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NN][4];
  zero(acc);
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) issue(r + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int i = r * SPLIT + wg;
    if (i < n_tiles) {
      const int k0 = k_begin + i * BK;
      const bf16* sK = ring + 2 * (SPLIT * (r & 1) + wg) * TILE;
      float s[8][4];
      zero(s);
      bf_abt<D>(s, sQ, sK, r0, lane);
      if (!all_seen(p, q0 + r0, 16, k0, BK)) {  // the warp's mask, where it has one
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = seen(p, q0 + r0 + g + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1)) ? s[j][e]
                                                                                      : NEG_INF;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        const float m_new = fmaxf(m[hr], quad_max(mx) * sl2);
        const float corr = ex2(m[hr] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * hr + e];
            x = ex2(fmaf(x, sl2, -m_new));
            rs += x;
          }
        l[hr] = l[hr] * corr + quad_sum(rs);
        m[hr] = m_new;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          acc[n][2 * hr] *= corr;
          acc[n][2 * hr + 1] *= corr;
        }
      }
      bf_pv<D>(acc, s, sK + TILE, lane);
    }
    __syncthreads();  // this stage is refilled by the next round
  }

  if (SPLIT > 1) {  // the ring is free: warpgroup 1's state joins warpgroup 0's
    float* buf = reinterpret_cast<float*>(ring) + wi * (16 * D + 128);
    float* ml = buf + 16 * D;  // m of rows g, g + 8; then l
    if (wg == 1) {
      stash(buf, acc, lane);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        ml[32 * hr + lane] = m[hr];
        ml[64 + 32 * hr + lane] = l[hr];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m1 = ml[32 * hr + lane], l1 = ml[64 + 32 * hr + lane];
      const float m_new = fmaxf(m[hr], m1);
      const float c0 = ex2(m[hr] - m_new), c1 = ex2(m1 - m_new);
      m[hr] = m_new;
      l[hr] = l[hr] * c0 + l1 * c1;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * hr + e;
          acc[n][x] = acc[n][x] * c0 + buf[(4 * n + x) * 32 + lane] * c1;
        }
    }
  }

  bf16* o = slice<bf16>(p.o, b, h);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    bf16* row = o + (int64_t)qi * p.o.ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      row[8 * n] = __float2bfloat16(acc[n][2 * hr] / den);
      row[8 * n + 1] = __float2bfloat16(acc[n][2 * hr + 1] / den);
    }
    if (t == 0) p.lse[((int64_t)b * p.Hq + h) * p.Sq + qi] = m[hr] * LN2 + logf(den);
  }
}

// grid (Hq, B, ceil(Sq/64)), SPLIT warpgroups: as flash_bwd_dq_kernel, on
// bf16 products, the grid ordered as flash_fwd_bf16_kernel's; o comes in
// as a tile too, and delta from the o and dO tiles in shared memory. A
// warp keeps its Q rows in fragments and walks a key tile 16 keys at a
// time (scores, dP, dS, then dS.K), so no 16 x 64 tile is live. It lets
// the dk/dv kernel launch once its blocks have all started (programmatic
// dependent launch: dk/dv waits for it before reading delta).
template <int D, int SPLIT, int MINB>
__global__ void __launch_bounds__(WG * SPLIT, MINB) flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int TILE = 64 * row_stride<bf16>(D), NN = D / 8;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sDO = sQ + TILE;
  bf16* sO = sDO + TILE;
  bf16* ring = sO + TILE;  // round r: K, V of key tile r SPLIT + w in slot SPLIT (r & 1) + w
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int wg = threadIdx.x / WG, wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wi * 16;
  const float sl2 = p.scale * LOG2E;
  const bf16* k = slice<bf16>(p.k, b, hk);
  const bf16* v = slice<bf16>(p.v, b, hk);
  const bf16* dout = slice<bf16>(p.dout, b, h);
  int k_begin, k_end;
  key_range(p, q0, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int n_rounds = (n_tiles + SPLIT - 1) / SPLIT;
  auto issue = [&](int r) {
#pragma unroll
    for (int w = 0; w < SPLIT; ++w) {
      if (r * SPLIT + w >= n_tiles) break;
      const int kt = k_begin + (r * SPLIT + w) * BK;
      bf16* dst = ring + 2 * (SPLIT * (r & 1) + w) * TILE;
      copy_tile<bf16, D>(dst, k, p.k.ss, kt, p.Sk, p.aligned & AL_K);
      copy_tile<bf16, D>(dst + TILE, v, p.v.ss, kt, p.Sk, p.aligned & AL_V);
    }
  };

  // o's 16-byte copies: its pointer and strides checked here (the wrapper
  // allocated it; a view of another layout takes the element copies)
  const bf16* o = slice<bf16>(p.o, b, h);
  const bool o_vec = reinterpret_cast<uintptr_t>(o) % 16 == 0 && p.o.ss * 2 % 16 == 0;
  copy_tile<bf16, D>(sQ, slice<bf16>(p.q, b, h), p.q.ss, q0, p.Sq, p.aligned & AL_Q);
  copy_tile<bf16, D>(sDO, dout, p.dout.ss, q0, p.Sq, p.aligned & AL_DO);
  copy_tile<bf16, D>(sO, o, p.o.ss, q0, p.Sq, o_vec);
  issue(0);
  cp_commit();
  allow_next_grid();

  const int64_t row0 = ((int64_t)b * p.Hq + h) * p.Sq;
  float lse2[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + g + 8 * hr;
    lse2[hr] = qi < p.Sq ? p.lse[row0 + qi] * LOG2E : 0.f;
  }

  uint32_t qa[D / 16][4];  // the warp's Q rows (its dO rows are read for each chunk)
  float acc[NN][4];
  zero(acc);
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) issue(r + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (r == 0) {
      // delta = rowsum(do * o) of the warp's 16 rows: lanes 2i and 2i+1
      // take half of row r0 + i each, 8 elements a 16-byte load; warpgroup
      // 0 writes it for the dk/dv kernel
      constexpr int LD = row_stride<bf16>(D);
      const int ri = r0 + (lane >> 1), c0 = (lane & 1) * (D / 2);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(sDO + ri * LD + c0 + c);
        const uint4 y = *reinterpret_cast<const uint4*>(sO + ri * LD + c0 + c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          d = fmaf(__uint_as_float(xs[u] << 16), __uint_as_float(ys[u] << 16), d);
          d = fmaf(__uint_as_float(xs[u] & 0xffff0000u), __uint_as_float(ys[u] & 0xffff0000u), d);
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      delta[0] = __shfl_sync(0xffffffffu, d, 2 * g);
      delta[1] = __shfl_sync(0xffffffffu, d, 2 * g + 16);
      if (wg == 0 && (lane & 1) == 0 && q0 + ri < p.Sq) p.delta[row0 + q0 + ri] = d;
      frags_a<D>(qa, sQ, r0, lane);
    }
    const int i = r * SPLIT + wg;
    if (i < n_tiles) {
      const int k0 = k_begin + i * BK;
      const bf16* sK = ring + 2 * (SPLIT * (r & 1) + wg) * TILE;
      const bool all = all_seen(p, q0 + r0, 16, k0, BK);
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // keys 16c .. 16c+15 of the tile
        float s[2][4], dp[2][4];  // [j][e]: row g (+8), key 16c + 8j + 2t (+1)
        uint32_t da[D / 16][4];
        zero(s);
        zero(dp);
        bf_abt16<D>(s, qa, sK, 16 * c, lane);
        frags_a<D>(da, sDO, r0, lane);
        bf_abt16<D>(dp, da, sK + TILE, 16 * c, lane);
        if (!all) {  // the warp's mask, where it has one
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = seen(p, q0 + r0 + g + 8 * (e >> 1), k0 + 16 * c + 8 * j + 2 * t + (e & 1))
                            ? s[j][e]
                            : NEG_INF;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            const float pv = ex2(fmaf(s[j][e], sl2, -lse2[hr]));
            s[j][e] = pv * (dp[j][e] - delta[hr]);  // dS
          }
        bf_pv16<D>(acc, s, sK, 16 * c, lane);
      }
    }
    __syncthreads();
  }

  if (SPLIT > 1) {
    float* buf = reinterpret_cast<float*>(ring) + wi * 16 * D;
    if (wg == 1) stash(buf, acc, lane);
    __syncthreads();
    if (wg == 1) return;
    add_stash(acc, buf, lane);
  }
  store_rows<bf16, D>(slice<bf16>(p.dq, b, h), p.dq.ss, q0 + r0, p.Sq, acc, p.scale, g, t);
}

// the dk/dv kernel's split of each key tile's iterations: nsplit parts;
// past 1, part j writes its f32 partial dk and dv (dk unscaled) to
// part[j] and part[nsplit + j], each (B, Hkv, Sk, D) dense
struct Split {
  float* part;
  int nsplit;
};

// rows row0 + g and row0 + g + 8 of a dense (S, D) f32 slice from acc; rows
// at or past nrows are not written
template <int D>
__device__ __forceinline__ void store_part(float* dst, int row0, int nrows,
                                           const float (&acc)[D / 8][4], int g, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + g + 8 * hr;
    if (r >= nrows) continue;
    float* row = dst + (int64_t)r * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) = make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
  }
}

// grid (Hkv nsplit, B, ceil(Sk/64)), SPLIT warpgroups: as
// flash_bwd_dkv_kernel, on bf16 products. Block (x, b, z) takes key tile
// z (tile 0, the longest causal chain, first) of kv head x / nsplit and
// part x % nsplit of its G nq (head, query tile) iterations, a contiguous
// range; with nsplit > 1 it writes f32 partial sums that
// flash_dkv_sum_kernel adds. A warp walks a query tile 16 queries at a
// time (Pᵀ, dPᵀ, dSᵀ, then Pᵀ.dO and dSᵀ.Q), so no 16 x 64 tile is live.
// Launched as the dq kernel's programmatic dependent: its K and V copies
// start while dq finishes, and it waits for dq's grid before its first
// read of delta.
template <int D, int SPLIT, int MINB>
__global__ void __launch_bounds__(WG * SPLIT, MINB) flash_bwd_dkv_bf16_kernel(const Params p,
                                                                            const Split sp) {
  constexpr int TILE = 64 * row_stride<bf16>(D), NN = D / 8;
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);
  bf16* sV = sK + TILE;
  bf16* ring = sV + TILE;  // slot s: Q at ring + 2s TILE, dO after it
  float* ring_f = reinterpret_cast<float*>(ring + 4 * SPLIT * TILE);  // slot s: lse, delta
  const int hk = blockIdx.x / sp.nsplit, part = blockIdx.x - hk * sp.nsplit;
  const int b = blockIdx.y, k0 = blockIdx.z * BK;
  const int G = p.Hq / p.Hkv;
  const int wg = threadIdx.x / WG, wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wi * 16;
  const float sl2 = p.scale * LOG2E;
  int q_begin, q_end;
  query_range(p, k0, q_begin, q_end);
  const int nq = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int it0 = part * G * nq / sp.nsplit, n_iter = (part + 1) * G * nq / sp.nsplit - it0;
  const int n_rounds = (n_iter + SPLIT - 1) / SPLIT;

  // iteration it0 + i: query head hk G + (it0 + i) / nq, query tile
  // q_begin + ((it0 + i) % nq) BQ
  auto issue = [&](int r) {
#pragma unroll
    for (int w = 0; w < SPLIT; ++w) {
      const int i = r * SPLIT + w;
      if (i >= n_iter) break;
      const int it = it0 + i, slot = SPLIT * (r & 1) + w;
      const int h = hk * G + it / nq, q0 = q_begin + (it % nq) * BQ;
      bf16* dst = ring + 2 * slot * TILE;
      copy_tile<bf16, D>(dst, slice<bf16>(p.q, b, h), p.q.ss, q0, p.Sq, p.aligned & AL_Q);
      copy_tile<bf16, D>(dst + TILE, slice<bf16>(p.dout, b, h), p.dout.ss, q0, p.Sq,
                         p.aligned & AL_DO);
      const int64_t row0 = ((int64_t)b * p.Hq + h) * p.Sq;
      for (int idx = threadIdx.x; idx < 2 * BQ; idx += blockDim.x) {
        const float* src = idx < BQ ? p.lse : p.delta;
        const int rq = q0 + (idx & (BQ - 1));
        const bool in = rq < p.Sq;
        cp_async4(ring_f + 2 * BQ * slot + idx, in ? src + row0 + rq : src, in ? 4 : 0);
      }
    }
  };

  copy_tile<bf16, D>(sK, slice<bf16>(p.k, b, hk), p.k.ss, k0, p.Sk, p.aligned & AL_K);
  copy_tile<bf16, D>(sV, slice<bf16>(p.v, b, hk), p.v.ss, k0, p.Sk, p.aligned & AL_V);
  wait_prior_grid();  // delta comes from the dq kernel
  issue(0);
  cp_commit();

  // the warp's K rows, kept in fragments at D <= 64; at D=128 they would
  // take registers that dk and dv need, so they are read for each chunk,
  // as the V rows always are
  constexpr bool KEEP_K = D <= 64;
  uint32_t ka[D / 16][4];
  float acc_k[NN][4], acc_v[NN][4];
  zero(acc_k);
  zero(acc_v);
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) issue(r + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (KEEP_K && r == 0) frags_a<D>(ka, sK, r0, lane);
    const int i = r * SPLIT + wg;
    if (i < n_iter) {
      const int q0 = q_begin + ((it0 + i) % nq) * BQ, slot = SPLIT * (r & 1) + wg;
      const bf16* sQ = ring + 2 * slot * TILE;
      const bf16* sDO = sQ + TILE;
      const float* sL = ring_f + 2 * BQ * slot;
      const float* sDelta = sL + BQ;
      const bool all = all_seen(p, q0, BQ, k0 + r0, 16);
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // queries 16c .. 16c+15 of the tile
        float s[2][4], dp[2][4];  // [j][e]: key row r0 + g (+8), query 16c + 8j + 2t (+1)
        uint32_t va[D / 16][4];
        zero(s);
        zero(dp);
        if (!KEEP_K) frags_a<D>(ka, sK, r0, lane);
        bf_abt16<D>(s, ka, sQ, 16 * c, lane);
        frags_a<D>(va, sV, r0, lane);
        bf_abt16<D>(dp, va, sDO, 16 * c, lane);
        if (!all) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = seen(p, q0 + 16 * c + 8 * j + 2 * t + (e & 1), k0 + r0 + g + 8 * (e >> 1))
                            ? s[j][e]
                            : NEG_INF;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cq = 16 * c + 8 * j + 2 * t + (e & 1);
            const float pv = ex2(fmaf(s[j][e], sl2, -sL[cq] * LOG2E));
            s[j][e] = pv;                             // Pᵀ
            dp[j][e] = pv * (dp[j][e] - sDelta[cq]);  // dSᵀ
          }
        bf_pv16<D>(acc_v, s, sDO, 16 * c, lane);
        bf_pv16<D>(acc_k, dp, sQ, 16 * c, lane);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  if (SPLIT > 1) {
    float* buf = reinterpret_cast<float*>(ring) + wi * 32 * D;
    if (wg == 1) {
      stash(buf, acc_k, lane);
      stash(buf + 16 * D, acc_v, lane);
    }
    __syncthreads();
    if (wg == 1) return;
    add_stash(acc_k, buf, lane);
    add_stash(acc_v, buf + 16 * D, lane);
  }
  if (sp.nsplit == 1) {
    store_rows<bf16, D>(slice<bf16>(p.dk, b, hk), p.dk.ss, k0 + r0, p.Sk, acc_k, p.scale, g, t);
    store_rows<bf16, D>(slice<bf16>(p.dv, b, hk), p.dv.ss, k0 + r0, p.Sk, acc_v, 1.f, g, t);
  } else {
    const int64_t plane = (int64_t)p.B * p.Hkv * p.Sk * D;
    float* dst = sp.part + part * plane + ((int64_t)b * p.Hkv + hk) * p.Sk * D;
    store_part<D>(dst, k0 + r0, p.Sk, acc_k, g, t);
    store_part<D>(dst + sp.nsplit * plane, k0 + r0, p.Sk, acc_v, g, t);
  }
}

// dk = scale · Σ_j part[j] and dv = Σ_j part[nsplit + j], j = 0, 1, ... in
// order, rounded to bf16: four elements of a (B, Hkv, Sk, D) row a thread
template <int D>
__global__ void __launch_bounds__(256) flash_dkv_sum_kernel(const Params p, const Split sp) {
  const int64_t plane = (int64_t)p.B * p.Hkv * p.Sk * D;
  const float4* part = reinterpret_cast<const float4*>(sp.part);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < plane / 4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 k = part[i], v = part[sp.nsplit * plane / 4 + i];
    for (int j = 1; j < sp.nsplit; ++j) {
      const float4 a = part[j * plane / 4 + i], c = part[(sp.nsplit + j) * plane / 4 + i];
      k.x += a.x, k.y += a.y, k.z += a.z, k.w += a.w;
      v.x += c.x, v.y += c.y, v.z += c.z, v.w += c.w;
    }
    const int64_t row = 4 * i / D;
    const int d = (int)(4 * i - row * D), s = (int)(row % p.Sk);
    const int bh = (int)(row / p.Sk), hk = bh % p.Hkv, b = bh / p.Hkv;
    bf16* dk = slice<bf16>(p.dk, b, hk) + (int64_t)s * p.dk.ss + d;
    bf16* dv = slice<bf16>(p.dv, b, hk) + (int64_t)s * p.dv.ss + d;
    dk[0] = __float2bfloat16(k.x * p.scale), dk[1] = __float2bfloat16(k.y * p.scale);
    dk[2] = __float2bfloat16(k.z * p.scale), dk[3] = __float2bfloat16(k.w * p.scale);
    dv[0] = __float2bfloat16(v.x), dv[1] = __float2bfloat16(v.y);
    dv[2] = __float2bfloat16(v.z), dv[3] = __float2bfloat16(v.w);
  }
}

// ---- host side: one launcher per kernel, dispatched on (dtype, D) ----

// the 16-byte copy path needs the base pointer and the stride of every
// dimension longer than 1 to be multiples of 16 bytes
bool aligned16(const View& t, int itemsize, int B, int H, int S) {
  return reinterpret_cast<uintptr_t>(t.p) % 16 == 0 && (B == 1 || t.sb * itemsize % 16 == 0) &&
         (H == 1 || t.sh * itemsize % 16 == 0) && (S == 1 || t.ss * itemsize % 16 == 0);
}

// the wrapper chooses the copy path of each operand (Params::aligned); a
// claim that does not hold is refused, never launched
cudaError_t check_aligned(const Params& p, int itemsize) {
  const bool ok = (!(p.aligned & AL_Q) || aligned16(p.q, itemsize, p.B, p.Hq, p.Sq)) &&
                  (!(p.aligned & AL_K) || aligned16(p.k, itemsize, p.B, p.Hkv, p.Sk)) &&
                  (!(p.aligned & AL_V) || aligned16(p.v, itemsize, p.B, p.Hkv, p.Sk)) &&
                  (!(p.aligned & AL_DO) || aligned16(p.dout, itemsize, p.B, p.Hq, p.Sq));
  return ok ? cudaSuccess : cudaErrorMisalignedAddress;
}

constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

// warpgroups of a block: 2 where its shared memory (fixed tiles, 2 stages
// of 2 tiles a warpgroup, extra bytes a warpgroup) fits, else 1
template <typename T, int D>
constexpr int split_for(int fixed_tiles, size_t extra) {
  return (fixed_tiles + 4 * 2) * tile_bytes<T>(D) + 2 * extra <= MAX_SMEM ? 2 : 1;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int split, size_t smem, cudaStream_t stream,
                   const Params& p, int itemsize) {
  cudaError_t err = check_aligned(p, itemsize);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WG * split, smem, stream>>>(p);
  return cudaGetLastError();
}

// Launch configuration of each kernel for (T, D): warpgroups a block and
// dynamic shared memory. fwd: Q + 2 stages of K, V a warpgroup; dq: Q, dO +
// 2 stages of K, V a warpgroup; dk/dv: K, V + 2 stages of Q, dO and 64 lse
// and delta values a warpgroup.
template <typename T, int D>
struct Config {
  static constexpr size_t rows = 4 * BQ * sizeof(float);
  static constexpr int fwd_split = split_for<T, D>(1, 0);
  static constexpr int dq_split = split_for<T, D>(2, 0);
  static constexpr int dkv_split = split_for<T, D>(2, rows);
  static constexpr size_t fwd_smem = (1 + 4 * fwd_split) * tile_bytes<T>(D);
  static constexpr size_t dq_smem = (2 + 4 * dq_split) * tile_bytes<T>(D);
  static constexpr size_t dkv_smem = (2 + 4 * dkv_split) * tile_bytes<T>(D) + dkv_split * rows;
};

// The bf16 kernels' configuration: SPLIT warpgroups and shared memory as
// Config's, and the blocks an SM their __launch_bounds__ ask for: 2 where
// two blocks' shared memory fits the SM's 228 KB (1 KB of it reserved a
// block), which caps a thread at 128 registers; else 1. dk/dv keeps 1: its
// two accumulators and two score tiles alone take 128 registers at D=64.
constexpr int blocks_per_sm(size_t smem) { return 2 * (smem + 1024) <= 233472 ? 2 : 1; }

template <int D>
struct ConfigBF16 {
  static constexpr size_t tile = tile_bytes<bf16>(D), rows = 4 * BQ * sizeof(float);
  static constexpr int split = 2;
  static constexpr size_t fwd_smem = (1 + 4 * split) * tile;
  static constexpr size_t dq_smem = (3 + 4 * split) * tile;  // Q, dO, o + the ring
  static constexpr size_t dkv_smem = (2 + 4 * split) * tile + split * rows;
  static constexpr int fwd_minb = blocks_per_sm(fwd_smem);
  static constexpr int dq_minb = blocks_per_sm(dq_smem);
  static constexpr int dkv_minb = 1;
};

template <int D>
cudaError_t fwd_bf16(const Params& p, cudaStream_t stream) {
  using C = ConfigBF16<D>;
  return launch(flash_fwd_bf16_kernel<D, C::split, C::fwd_minb>,
                dim3(p.Hq, p.B, (p.Sq + BQ - 1) / BQ), C::split, C::fwd_smem, stream, p, 2);
}

template <int D>
cudaError_t bwd_dq_bf16(const Params& p, cudaStream_t stream) {
  using C = ConfigBF16<D>;
  return launch(flash_bwd_dq_bf16_kernel<D, C::split, C::dq_minb>,
                dim3(p.Hq, p.B, (p.Sq + BQ - 1) / BQ), C::split, C::dq_smem, stream, p, 2);
}

template <int D>
cudaError_t bwd_dkv_bf16(const Params& p, const Split& sp, cudaStream_t stream) {
  using C = ConfigBF16<D>;
  if (sp.nsplit < 1 || (sp.nsplit > 1 && sp.part == nullptr)) return cudaErrorInvalidValue;
  const auto kernel = flash_bwd_dkv_bf16_kernel<D, C::split, C::dkv_minb>;
  cudaError_t err = check_aligned(p, 2);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::dkv_smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.Hkv * sp.nsplit, p.B, (p.Sk + BK - 1) / BK);
  cfg.blockDim = dim3(WG * C::split);
  cfg.dynamicSmemBytes = C::dkv_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // after the dq kernel
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p, sp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_sum_bf16(const Params& p, const Split& sp, cudaStream_t stream) {
  if (sp.nsplit < 2 || sp.part == nullptr) return cudaErrorInvalidValue;
  const int64_t n4 = (int64_t)p.B * p.Hkv * p.Sk * D / 4;
  if (n4 == 0) return cudaSuccess;
  const int blocks = (int)(n4 < 132 * 8 * 256 ? (n4 + 255) / 256 : 132 * 8);
  flash_dkv_sum_kernel<D><<<blocks, 256, 0, stream>>>(p, sp);
  return cudaGetLastError();
}

template <int D>
cudaError_t config_bf16(int kind, int* warpgroups, int* smem) {
  using C = ConfigBF16<D>;
  if (kind < 0 || kind > 2) return cudaErrorInvalidValue;
  *warpgroups = C::split;
  *smem = (int)(kind == 0 ? C::fwd_smem : kind == 1 ? C::dq_smem : C::dkv_smem);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t fwd(const Params& p, cudaStream_t stream) {
  using C = Config<T, D>;
  return launch(flash_fwd_kernel<T, D, C::fwd_split>, dim3((p.Sq + BQ - 1) / BQ, p.Hq, p.B),
                C::fwd_split, C::fwd_smem, stream, p, sizeof(T));
}

template <typename T, int D>
cudaError_t bwd_dq(const Params& p, cudaStream_t stream) {
  using C = Config<T, D>;
  return launch(flash_bwd_dq_kernel<T, D, C::dq_split>, dim3((p.Sq + BQ - 1) / BQ, p.Hq, p.B),
                C::dq_split, C::dq_smem, stream, p, sizeof(T));
}

template <typename T, int D>
cudaError_t bwd_dkv(const Params& p, cudaStream_t stream) {
  using C = Config<T, D>;
  return launch(flash_bwd_dkv_kernel<T, D, C::dkv_split>, dim3((p.Sk + BK - 1) / BK, p.Hkv, p.B),
                C::dkv_split, C::dkv_smem, stream, p, sizeof(T));
}

template <typename T, int D>
cudaError_t config(int kind, int* warpgroups, int* smem) {
  using C = Config<T, D>;
  if (kind < 0 || kind > 2) return cudaErrorInvalidValue;
  *warpgroups = kind == 0 ? C::fwd_split : kind == 1 ? C::dq_split : C::dkv_split;
  *smem = (int)(kind == 0 ? C::fwd_smem : kind == 1 ? C::dq_smem : C::dkv_smem);
  return cudaSuccess;
}

// dtype: 0 float32; D: 32, 64 or 128
#define FLASH_DISPATCH(FN, ...)                                   \
  switch (dtype * 1000 + D) {                                      \
    case 32: return FN<float, 32>(__VA_ARGS__);                    \
    case 64: return FN<float, 64>(__VA_ARGS__);                    \
    case 128: return FN<float, 128>(__VA_ARGS__);                  \
    default: return cudaErrorInvalidValue;                         \
  }

// bf16 (dtype 1): the kernels of the bf16 section
#define FLASH_DISPATCH_BF16(FN, ...)                              \
  switch (D) {                                                     \
    case 32: return FN<32>(__VA_ARGS__);                           \
    case 64: return FN<64>(__VA_ARGS__);                           \
    case 128: return FN<128>(__VA_ARGS__);                         \
    default: return cudaErrorInvalidValue;                         \
  }

Params make_params(int D, int B, int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                   int aligned) {
  Params p = {};
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.aligned = aligned;
  p.scale = (float)(1.0 / sqrt((double)D));  // D ** -0.5, rounded once to f32
  return p;
}

View view(const void* ptr, int64_t sb, int64_t sh, int64_t ss) {
  return View{const_cast<void*>(ptr), sb, sh, ss};
}

cudaError_t run_fwd(int dtype, int D, const Params& p, cudaStream_t stream) {
  if (dtype == 1) FLASH_DISPATCH_BF16(fwd_bf16, p, stream)
  FLASH_DISPATCH(fwd, p, stream)
}
cudaError_t run_dq(int dtype, int D, const Params& p, cudaStream_t stream) {
  if (dtype == 1) FLASH_DISPATCH_BF16(bwd_dq_bf16, p, stream)
  FLASH_DISPATCH(bwd_dq, p, stream)
}
// float32 takes no split (nsplit 1)
cudaError_t run_dkv(int dtype, int D, const Params& p, const Split& sp, cudaStream_t stream) {
  if (dtype == 1) FLASH_DISPATCH_BF16(bwd_dkv_bf16, p, sp, stream)
  if (sp.nsplit != 1) return cudaErrorInvalidValue;
  FLASH_DISPATCH(bwd_dkv, p, stream)
}
cudaError_t run_dkv_sum(int dtype, int D, const Params& p, const Split& sp,
                        cudaStream_t stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  FLASH_DISPATCH_BF16(dkv_sum_bf16, p, sp, stream)
}
cudaError_t run_config(int kind, int dtype, int D, int* warpgroups, int* smem) {
  if (dtype == 1) FLASH_DISPATCH_BF16(config_bf16, kind, warpgroups, smem)
  FLASH_DISPATCH(config, kind, warpgroups, smem)
}

}  // namespace

// Each (B,H,S,D) tensor is passed as its pointer and its batch, head and
// sequence strides in elements; lse and delta are dense (B,Hq,Sq) float32.
// aligned: bit 1 q, 2 k, 4 v, 8 do take the 16-byte copy path (see
// aligned16). Returns the cudaError_t of the launch (0 on success).

extern "C" int flash_attention_fwd(int dtype, int D, int B, int Hq, int Hkv, int Sq, int Sk,
                                   int causal, int window, int aligned,
                                   const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                   const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                   const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   void* o, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                   float* lse, void* stream) {
  Params p = make_params(D, B, Hq, Hkv, Sq, Sk, causal, window, aligned);
  p.q = view(q, q_sb, q_sh, q_ss);
  p.k = view(k, k_sb, k_sh, k_ss);
  p.v = view(v, v_sb, v_sh, v_ss);
  p.o = view(o, o_sb, o_sh, o_ss);
  p.lse = lse;
  return (int)run_fwd(dtype, D, p, static_cast<cudaStream_t>(stream));
}

// writes delta = rowsum(do * o) (B,Hq,Sq) besides dq
extern "C" int flash_attention_bwd_dq(int dtype, int D, int B, int Hq, int Hkv, int Sq, int Sk,
                                      int causal, int window, int aligned,
                                      const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                      const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                      const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                      const void* dout, int64_t do_sb, int64_t do_sh,
                                      int64_t do_ss,
                                      const void* o, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                      const float* lse, float* delta,
                                      void* dq, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
                                      void* stream) {
  Params p = make_params(D, B, Hq, Hkv, Sq, Sk, causal, window, aligned);
  p.q = view(q, q_sb, q_sh, q_ss);
  p.k = view(k, k_sb, k_sh, k_ss);
  p.v = view(v, v_sb, v_sh, v_ss);
  p.dout = view(dout, do_sb, do_sh, do_ss);
  p.o = view(o, o_sb, o_sh, o_ss);
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = view(dq, dq_sb, dq_sh, dq_ss);
  return (int)run_dq(dtype, D, p, static_cast<cudaStream_t>(stream));
}

// reads the delta that flash_attention_bwd_dq wrote; nsplit: the parts of
// each key tile's iterations (float32: 1; bf16 past 1: f32 partial sums in
// part, 2 nsplit (B, Hkv, Sk, D) planes, for flash_attention_dkv_sum)
extern "C" int flash_attention_bwd_dkv(int dtype, int D, int B, int Hq, int Hkv, int Sq, int Sk,
                                       int causal, int window, int aligned,
                                       const void* q, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                       const void* k, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                                       const void* v, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                       const void* dout, int64_t do_sb, int64_t do_sh,
                                       int64_t do_ss, const float* lse, const float* delta,
                                       void* dk, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                                       void* dv, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                                       int nsplit, float* part, void* stream) {
  Params p = make_params(D, B, Hq, Hkv, Sq, Sk, causal, window, aligned);
  p.q = view(q, q_sb, q_sh, q_ss);
  p.k = view(k, k_sb, k_sh, k_ss);
  p.v = view(v, v_sb, v_sh, v_ss);
  p.dout = view(dout, do_sb, do_sh, do_ss);
  p.lse = const_cast<float*>(lse);
  p.delta = const_cast<float*>(delta);
  p.dk = view(dk, dk_sb, dk_sh, dk_ss);
  p.dv = view(dv, dv_sb, dv_sh, dv_ss);
  return (int)run_dkv(dtype, D, p, Split{part, nsplit}, static_cast<cudaStream_t>(stream));
}

// bf16 only, after flash_attention_bwd_dkv with nsplit > 1 on the same
// stream: dk and dv from its f32 partial sums (part, 2 nsplit dense
// (B, Hkv, Sk, D) planes, dk's first)
extern "C" int flash_attention_dkv_sum(int dtype, int D, int B, int Hkv, int Sk, int nsplit,
                                       const float* part,
                                       void* dk, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                                       void* dv, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                                       void* stream) {
  Params p = make_params(D, B, Hkv, Hkv, 0, Sk, 0, 0, 0);
  p.dk = view(dk, dk_sb, dk_sh, dk_ss);
  p.dv = view(dv, dv_sb, dv_sh, dv_ss);
  return (int)run_dkv_sum(dtype, D, p, Split{const_cast<float*>(part), nsplit},
                          static_cast<cudaStream_t>(stream));
}

// the launch configuration of kernel kind (0 fwd, 1 dq, 2 dk/dv) for
// (dtype, D): warpgroups a block (threads = 128 x warpgroups) and dynamic
// shared memory bytes
extern "C" int flash_attention_config(int kind, int dtype, int D, int* warpgroups,
                                      int* smem_bytes) {
  return (int)run_config(kind, dtype, D, warpgroups, smem_bytes);
}
