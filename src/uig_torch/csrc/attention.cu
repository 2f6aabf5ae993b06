// Single-head attention over (B, N, D), fp32 or bf16: the forward (K5f) and
// its backward (K5b).
//
//   O = softmax(scale * Q K^T) V,  scale = 1 / sqrt(D), softmax per row
//   dV = P^T dO      dP = dO V^T      dS = P o (dP - rowsum(dO o O))
//   dQ = scale dS K  dK = scale dS^T Q
//
// Replaces: src/uig/kernels/attention_pallas.py, _attention_fwd_impl ->
// _attn_kernel (K5f) and _attention_bwd_impl -> _attn_bwd_kernel (K5b). The
// TPU kernels keep the whole of K and V (2 MiB each at N = 1024, D = 512) in
// VMEM and take each q block's softmax row in one piece; dK/dV accumulate in
// a VMEM block across a sequential q-block grid.
//
// Numerics: the three-term TF32 split on the tensor cores. Each fp32
// operand x of a product becomes hi = rna_tf32(x) and lo = rna_tf32(x - hi),
// each rounded to the nearest TF32 value explicitly (the tensor core
// truncates the low 13 bits of a raw fp32 input; `split`, csrc/tf32.cuh),
// and each product is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b, in that
// order, into fp32 accumulators (mma.sync m16n8k8 tf32). hi + lo carries
// 22 of x's 24 significand bits and the dropped lo_a lo_b term is 2^-22 of
// the product, so the products keep fp32's order of error; plain
// single-pass TF32 (2^-11) would not. The softmax, its rescales, the
// log-sum-exp, delta = rowsum(dO o O) and every epilogue are fp32 FMAs.
// Every sum runs in a fixed order and nothing uses atomics, so repeats are
// bit-equal.
//
// bf16 storage (T = bf16: q, k, v, dO in, o, dq, dk, dv out), as the Pallas
// kernels take bf16: every value is widened to fp32 and the math is the
// fp32 kernels' (P, dS, the softmax and every sum stay fp32); each output
// is rounded to bf16 once, from the fp32 value the fp32 kernel computes.
// A bf16 value is exact in TF32 (its lo is 0), so a bf16 operand enters
// its products as hi alone and the terms of its lo, exact zeros, are
// dropped: Q K^T and dO V^T keep hi_a hi_b, the products of an fp32
// operand (P, P^T, dS, dS^T) with a bf16 one keep lo_a hi_b and hi_a hi_b,
// in the split's order. The result is bit-equal to the fp32 kernel run on
// the widened inputs, up to the sign of a zero: 3 TF32 products of 6 in
// the forward, 8 of 15 in the backward. P is not rounded to bf16 before
// P V (FlashAttention's kernels round it; the JAX kernel keeps it fp32).
// The forward also writes the fp32 O beside the bf16 one (o32): the
// backward's delta is taken from it, since delta from the rounded O moves
// dS = P o (dP - delta) where dP and delta nearly cancel. bf16 values stay
// bf16 in shared memory (cp.async cannot convert, and a copy staged
// through registers would wait on each load in blocks that run one to an
// SM) and are widened where the fragments are read, with row strides that
// keep those reads free of bank conflicts (`Ld`).
//
// Bound on this card: operations. fp32: 3 TF32 products per fp32 product,
// at 495 TFLOP/s dense TF32 (H100 SXM data sheet, 700 W). The forward is
// two products of 2 B N^2 D flops (17.2 GFLOP at (8, 1024, 512): 0.104 ms),
// the backward five (0.260 ms). bf16, counting a product of two bf16
// values at the bf16 rate (989 TFLOP/s) and each TF32 term of a product
// with an fp32 operand at 495: forward 0.043 ms, backward 0.122 ms at (8,
// 1024, 512). The bytes (q, k, v, o, dO and the gradients) take 0.02-0.04
// ms at 3.35 TB/s; the backward's P^T and dS^T scratch adds 2 B N^2 floats
// written and 3 B N^2 read.
//
// Design. mma.sync reads its fragments from registers, so every operand
// orientation the seven products need is an addressing choice when the
// fragments are read from padded shared memory, and the split is done in
// registers as they are loaded. Every fragment takes the k8 step's k in
// the order 0, 2, 4, 6, 1, 3, 5, 7 on both sides (lane t holds k = 2t and
// 2t + 1), which leaves the product unchanged and keeps the reads
// conflict-free:
//   * "row" operands, A[i][k] = A[i * lda + k] and B[k][n] = M[n][k]: a
//     float2 (bf16: a bf16 pair) a row, rows at a stride of 8 (bf16: 4) mod
//     32 words (S = Q K^T, S^T = K Q^T, dP^T = V dO^T, and the scratch's
//     rows as A of dV and dK);
//   * "pair" operands, B[k][n] = M[k][n] from rows 2t and 2t + 1 at a
//     stride of 4 (bf16: 36) mod 32 words, with A from hi/lo planes or the
//     scratch's columns (O += P V, dV = P^T dO, dK = dS^T Q, dQ = dS K).
// Blocks stream their operands through a 3-stage cp.async ring cut along D
// (or along the keys); rows and columns past N or D load as zeros
// (cp.async with src-size 0), scores past N are -inf (P = 0), and outputs
// past N are not stored. D is padded to a multiple of 64 in shared memory.
// The tensor core's own fp32 accumulation may truncate: each 32- or 64-deep
// slice of a sum (12 or 24 mma) is formed in zeroed fragments and added to
// the running sum with a rounded fp32 add (summed in the accumulator over
// all 1024 keys at once, the gradients landed over the 1e-5 gate from the
// plain version on an H100).
//   * Forward (attn_fwd_tc_kernel): a block of 8 warps owns 64 q rows, Q
//     resident (130 KB at D = 512 in fp32, 65 KB in bf16); per tile of 64
//     keys it streams K's 64 x 64 D-chunks (S on the tensor cores), takes
//     an online softmax in registers (the row max shared through shared
//     memory between the two warps of a row group, row sums kept per warp
//     and added in warp order at the end), writes P's hi/lo planes, then
//     streams V's D-chunks: O = alpha O + P V, one rounded FMA a chunk. O
//     stays in registers (a warp owns 16 rows x D / 2 columns). Writes O /
//     l and lse = m + log l.
//     Where one block a q tile would fill at most half the SMs (the
//     reconstruct apply's batch 4), the key tiles are cut into two ranges,
//     a block each, and attn_combine_kernel merges the two partial (O, lse)
//     in a fixed order. tools/attention_designs.py times this against
//     32-row blocks (this file built with UIG_ATTN_BQ=32).
//   * Backward, five products beside attn_delta_kernel (rowsum(dO o O)):
//     attn_scores_tc_kernel forms S^T and dP^T for a tile of 128 keys x 128
//     q rows (8 warps, 32 x 64 a warp; (K, Q) then (V, dO) chunk pairs 32
//     deep in D) and writes P^T = exp(scale S^T - lse) and dS^T = P^T o
//     (dP^T - delta) to a key-major scratch (2 x B x Np x Np fp32, Np = N
//     rounded up to 128: 8 B Np^2 bytes, 64 MiB at vqgan512's (8, 1024),
//     256 MiB at vaegan256's (32, 1024) on one card, 1 GiB at (8, 4096);
//     the one term that grows with N^2); attn_dv_tc_kernel,
//     attn_dk_tc_kernel and attn_dq_tc_kernel are one tiled GEMM over that
//     scratch (128 x 128 of the output a block, 8 warps, 32 x 64 a warp):
//     dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. No product is
//     recomputed. FlashAttention-2's shape, a dK/dV kernel with both
//     accumulators in registers and dS alone in the scratch, fits only 32
//     keys a block at D = 512 (64 keys' dK and dV would fill the register
//     file); tools/attention_designs.cu holds it, and
//     tools/attention_designs.py times it against this design.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dtype.cuh"
#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kC = 64;         // a chunk: 64 rows x 64 columns
constexpr int kLdr = kC + 8;   // row stride of a "row" operand, = 8 mod 32
constexpr int kLdc = kC + 4;   // row stride of a "pair" B chunk, = 4 mod 32
constexpr int kLdp = kC + 8;   // hi/lo plane row stride, = 8 mod 32
constexpr int kSlot = kC * kLdr;  // a chunk of either stride
constexpr int kMaxChunks = 8;  // D <= 512
constexpr int kBK = 64;        // keys a tile (forward)
#ifndef UIG_ATTN_BQ
#define UIG_ATTN_BQ 64
#endif
constexpr int kBQ = UIG_ATTN_BQ;  // q rows a forward block (32 or 64)
constexpr int kGThreads = 256;  // the backward's product kernels: 8 warps,
constexpr int kGFrag = 8;       // each 32 x 64 of the output (2 x 8 n8 tiles)
constexpr int kScoreTile = 128;  // keys and q rows of a scores block
constexpr int kSK = 32;          // the scores kernel's D-chunk depth
constexpr int kLdS = kSK + 8;    // its chunk row stride, = 8 mod 32
constexpr int kGR = 128, kGN = 128, kGK = 32;  // the scratch GEMMs' tiles
constexpr int kLdT = kGR + 4;  // chunk rows of 128 (M; A under TRANS)
constexpr int kLdA = kGK + 8;  // chunk rows of 32 (A without TRANS)

// Row strides, in elements, of the chunks of storage type T in shared
// memory. fp32 as above. bf16: a 16-byte cp.async needs a multiple of 8
// elements; a "row" read (a bf16 pair at word i ld / 2 + 4 ks + t for rows
// i = g) is conflict-free for ld / 2 = 4 mod 8 (72, 40 and D + 8 with D a
// multiple of 64); a "pair" read (one bf16 at word 2t ld / 2 + n / 2 with
// n / 2 = g / 2 + const) for ld / 2 = 4 mod 16 (72; 136 for the M chunks of
// 128 columns).
template <typename T>
struct Ld {
  static constexpr int pair = kLdc;  // "pair" B chunk of 64 columns
  static constexpr int m = kLdT;       // M chunk of 128 columns (GEMMs)
};
template <>
struct Ld<bf16> {
  static constexpr int pair = kC + 8;
  static constexpr int m = kGN + 8;
};

// T operands are split into hi and lo for fp32 and enter as hi alone for
// bf16, which TF32 holds exactly.
template <typename T>
constexpr bool kSplit = std::is_same<T, float>::value;

// ------------------------------------------------------------- PTX glue --
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Barrier `id` (1..4) over the `count` threads of one row group's warps.
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory reads widened to fp32: two consecutive values, or one.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const bf16* p) {
  return __bfloat162float(*p);
}
// Two consecutive outputs, each rounded once to the storage type.
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// x, a value of storage type T widened to fp32, as the TF32 operand of a
// product: hi and lo for fp32 (`split`); hi = x for bf16, lo unused.
template <typename T>
__device__ __forceinline__ void operand(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kSplit<T>)
    split(x, hi, lo);
  else
    hi = __float_as_uint(x);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c[j] += a b_j in the split's terms, lo_a hi_b (if A is split), hi_a lo_b
// (if B is split), hi_a hi_b, in that order for every j; b[j] = {b0, b1} of
// fragment j. The terms run across all j in turn, so consecutive mma are
// independent. A term left out is a product with an exact zero.
template <bool SA, bool SB, int NT>
__device__ __forceinline__ void mma_terms(float (&c)[NT][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[NT][2],
                                          const uint32_t (&bl)[NT][2]) {
  if constexpr (SA) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(c[j], al, bh[j][0], bh[j][1]);
  }
  if constexpr (SB) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(c[j], ah, bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(c[j], ah, bh[j][0], bh[j][1]);
}
// The same with b[j] = {b0, b1}, values of storage type TB, made operands
// here.
template <bool SA, typename TB, int NT>
__device__ __forceinline__ void mma_terms(float (&c)[NT][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float (&b)[NT][2]) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    operand<TB>(b[j][0], bh[j][0], bl[j][0]);
    operand<TB>(b[j][1], bh[j][1], bl[j][1]);
  }
  mma_terms<SA, kSplit<TB>>(c, ah, al, bh, bl);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}
template <int NT>
__device__ __forceinline__ void add_to(float (&acc)[NT][4],
                                       const float (&part)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// c[j] (16 x 8) += A (16 x 64) B_j over one chunk's 64-deep k, with "row"
// operands of storage type T: A[i][k] = A[i * lda + k], B_j[k][n] = Bc[(nb
// + 8 j + n) * kLdr + k] (a chunk). Lane (g, t) takes k = 2t and 2t + 1 of
// each k8 step, one pair a row, as the fragment's k = t and t + 4. g =
// lane / 4, t = lane % 4.
template <typename T, int NT>
__device__ __forceinline__ void prod_row(float (&c)[NT][4], const T* A,
                                         int lda, const T* Bc, int nb, int g,
                                         int t) {
#pragma unroll
  for (int ks = 0; ks < kC / 8; ++ks) {
    const int k = 8 * ks + 2 * t;
    const float2 x = ld2(A + g * lda + k);
    const float2 y = ld2(A + (g + 8) * lda + k);
    uint32_t ah[4], al[4];
    operand<T>(x.x, ah[0], al[0]);
    operand<T>(y.x, ah[1], al[1]);
    operand<T>(x.y, ah[2], al[2]);
    operand<T>(y.y, ah[3], al[3]);
    float b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 v = ld2(Bc + (nb + 8 * j + g) * kLdr + k);
      b[j][0] = v.x;
      b[j][1] = v.y;
    }
    mma_terms<kSplit<T>, T>(c, ah, al, b);
  }
}

// c[j] (16 x 8) += A (16 x 64) B_j over one chunk's 64-deep k, with "pair"
// operands: A from the fp32 hi/lo planes Ahi/Alo (row stride kLdp, A[i][k]
// at i * kLdp + k, as `split` leaves them), B_j[k][n] = Bc[k * Ld<T>::pair
// + nb + 8 j + n], of storage type T. Lane (g, t) takes k = 2t and 2t + 1
// of each k8 step as the fragment's k = t and t + 4.
template <typename T, int NT>
__device__ __forceinline__ void prod_pair(float (&c)[NT][4], const float* Ahi,
                                          const float* Alo, const T* Bc,
                                          int nb, int g, int t) {
  constexpr int ld = Ld<T>::pair;
#pragma unroll
  for (int ks = 0; ks < kC / 8; ++ks) {
    const int k = 8 * ks + 2 * t;
    const float2 h0 = *reinterpret_cast<const float2*>(Ahi + g * kLdp + k);
    const float2 h1 =
        *reinterpret_cast<const float2*>(Ahi + (g + 8) * kLdp + k);
    const float2 l0 = *reinterpret_cast<const float2*>(Alo + g * kLdp + k);
    const float2 l1 =
        *reinterpret_cast<const float2*>(Alo + (g + 8) * kLdp + k);
    const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                            __float_as_uint(h0.y), __float_as_uint(h1.y)};
    const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                            __float_as_uint(l0.y), __float_as_uint(l1.y)};
    float b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b[j][0] = ld1(Bc + k * ld + nb + 8 * j + g);
      b[j][1] = ld1(Bc + (k + 1) * ld + nb + 8 * j + g);
    }
    mma_terms<true, T>(c, ah, al, b);
  }
}

// The hi/lo planes of one C fragment (rows r, r + 8; columns col, col + 1).
__device__ __forceinline__ void put_planes(float* hi, float* lo, int r,
                                           int col, const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], h[e], l[e]);
  *reinterpret_cast<uint2*>(hi + r * kLdp + col) = make_uint2(h[0], h[1]);
  *reinterpret_cast<uint2*>(hi + (r + 8) * kLdp + col) =
      make_uint2(h[2], h[3]);
  *reinterpret_cast<uint2*>(lo + r * kLdp + col) = make_uint2(l[0], l[1]);
  *reinterpret_cast<uint2*>(lo + (r + 8) * kLdp + col) =
      make_uint2(l[2], l[3]);
}

// Rows [r0, r0 + R) x columns [c0, c0 + W) of M (row stride ldm) into shared
// memory with row stride lds; zeros at rows >= rlim or columns >= clim.
// 16 bytes a copy (4 fp32 or 8 bf16 values). Issues cp.async without
// committing.
template <typename T>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* M, int ldm,
                                          int r0, int c0, int R, int W,
                                          int rlim, int clim) {
  constexpr int E = 16 / sizeof(T);
  const int we = W / E;
  for (int p = threadIdx.x; p < R * we; p += kThreads) {
    const int r = p / we, c = E * (p - r * we);
    const bool ok = r0 + r < rlim && c0 + c < clim;
    cp_async16(s + r * lds + c, ok ? M + (size_t)(r0 + r) * ldm + c0 + c : M,
               ok);
  }
}
// The same for a box of R x W known at compile time, loaded by a block of
// NT threads.
template <int R, int W, int NT, typename T>
__device__ __forceinline__ void load_box(T* s, int lds, const T* M, int ldm,
                                         int r0, int c0, int rlim, int clim) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < R * W / E / NT; ++i) {
    const int p = threadIdx.x + i * NT;
    const int r = p / (W / E), c = E * (p % (W / E));
    const bool ok = r0 + r < rlim && c0 + c < clim;
    cp_async16(s + r * lds + c, ok ? M + (size_t)(r0 + r) * ldm + c0 + c : M,
               ok);
  }
}

// The ring: chunk j lives in stage j % kStages. ring_step(j) waits for
// chunk j, syncs the block (so the stage of chunk j - 1 is free and every
// shared write before it is visible), and issues chunk j + kStages - 1.
template <typename Issue>
__device__ __forceinline__ void ring_step(int j, Issue& issue) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  issue(j + kStages - 1);
}

// ---------------------------------------------------------------- K5f ---
// Grid (q tiles, B, S): split z of S takes its share of the key tiles and
// writes O and lse for those keys alone to o and lse, offset by z B N D and
// z B N (S = 1: the outputs; S = 2: the partial results, TO = float, that
// attn_combine_kernel merges). Where TO rounds (bf16), o32 receives the
// fp32 O too.
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, TO* __restrict__ o,
                       float* __restrict__ lse, int N, int D, float scale,
                       float* __restrict__ o32) {
  constexpr int WC = 8 / (kBQ / 16);  // warps sharing a 16-row group
  constexpr int KW = kBK / WC;       // keys of S a warp forms
  constexpr int SN = KW / 8;         // ... in n8 tiles
  constexpr int ON = 8 / WC;         // O n8 tiles a warp owns per chunk
  extern __shared__ float4 smem4[];
  const int nc = (D + kC - 1) / kC, ldq = nc * kC + 8;
  T* sQ = reinterpret_cast<T*>(smem4);  // kBQ x ldq
  T* ring = sQ + kBQ * ldq;             // kStages x kSlot
  float* pHi = reinterpret_cast<float*>(ring + kStages * kSlot);  // kBQ x kLdp
  float* pLo = pHi + kBQ * kLdp;
  float* sMax = pLo + kBQ * kLdp;  // WC x kBQ
  float* sSum = sMax + WC * kBQ;   // WC x kBQ
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp / WC, wc = warp % WC;
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ, r0 = 16 * wr;
  const size_t base = (size_t)b * N * D;
  const T *kb = k + base, *vb = v + base;
  const int tiles = (N + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * tiles / gridDim.z;
  const int kt1 = (blockIdx.z + 1) * tiles / gridDim.z;
  o += (size_t)blockIdx.z * gridDim.y * N * D;
  lse += (size_t)blockIdx.z * gridDim.y * N;
  const int per_tile = 2 * nc, total = (kt1 - kt0) * per_tile;
  auto slot = [&](int j) { return ring + (j % kStages) * kSlot; };
  auto issue = [&](int j) {
    if (j < total) {
      const int kt = kt0 + j / per_tile, r = j - (kt - kt0) * per_tile;
      // K chunks as "row" B, V chunks as "pair" B
      load_box<kC, kC, kThreads>(slot(j), r < nc ? kLdr : Ld<T>::pair,
                                 r < nc ? kb : vb, D, kt * kBK,
                                 (r < nc ? r : r - nc) * kC, N, D);
    }
    cp_async_commit();
  };
  load_tile(sQ, ldq, q + base, D, q0, 0, kBQ, nc * kC, N, D);
  issue(0);
  issue(1);

  float acc[kMaxChunks * ON][4];
  zero(acc);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  int j = 0;
  for (int k0 = kt0 * kBK; k0 < min(kt1 * kBK, N); k0 += kBK) {
    float s[SN][4];
    zero(s);
    for (int dc = 0; dc < nc; ++dc, ++j) {
      ring_step(j, issue);
      float part[SN][4];
      zero(part);
      prod_row(part, sQ + r0 * ldq + dc * kC, ldq, slot(j), wc * KW, g, t);
      add_to(s, part);
    }
    // online softmax over this tile's keys: each warp the max of its KW
    // columns, the row group's max through sMax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < SN; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + wc * KW + 8 * i + 2 * t + (e & 1);
        s[i][e] = key < N ? s[i][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if (t == 0) {
      sMax[wc * kBQ + r0 + g] = mx[0];
      sMax[wc * kBQ + r0 + g + 8] = mx[1];
    }
    group_sync(1 + wr, 32 * WC);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = m_run[h];
#pragma unroll
      for (int c = 0; c < WC; ++c) m = fmaxf(m, sMax[c * kBQ + r0 + g + 8 * h]);
      alpha[h] = expf(m_run[h] - m);
      m_run[h] = m;
    }
#pragma unroll
    for (int i = 0; i < SN; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = expf(s[i][e] - m_run[e >> 1]);
        rs[e >> 1] += s[i][e];
      }
      put_planes(pHi, pLo, r0 + g, wc * KW + 8 * i + 2 * t, s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l_run[h] = l_run[h] * alpha[h] + rs[h];
    }
    // O = alpha O + P V, one D-chunk of V at a time
#pragma unroll
    for (int dc = 0; dc < kMaxChunks; ++dc) {
      if (dc < nc) {
        ring_step(j, issue);
        float part[ON][4];
        zero(part);
        prod_pair(part, pHi + r0 * kLdp, pLo + r0 * kLdp, slot(j),
                  8 * ON * wc, g, t);
#pragma unroll
        for (int i = 0; i < ON; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[dc * ON + i][e] =
                fmaf(acc[dc * ON + i][e], alpha[e >> 1], part[i][e]);
        ++j;
      }
    }
  }
  cp_async_wait<0>();
  // l: the row group's per-warp sums, added in warp order
  if (t == 0) {
    sSum[wc * kBQ + r0 + g] = l_run[0];
    sSum[wc * kBQ + r0 + g + 8] = l_run[1];
  }
  group_sync(1 + wr, 32 * WC);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < WC; ++c) l[h] += sSum[c * kBQ + r0 + g + 8 * h];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int dc = 0; dc < kMaxChunks; ++dc)
#pragma unroll
      for (int i = 0; i < ON; ++i) {
        const int n = dc * kC + 8 * (ON * wc + i) + 2 * t;
        if (dc < nc && n < D) {
          const size_t at = base + (size_t)row * D + n;
          const float x = acc[dc * ON + i][2 * h] / l[h];
          const float y = acc[dc * ON + i][2 * h + 1] / l[h];
          st2(o + at, x, y);
          if constexpr (!std::is_same<TO, float>::value) st2(o32 + at, x, y);
        }
      }
    if (wc == 0 && t == 0) lse[(size_t)b * N + row] = m_run[h] + logf(l[h]);
  }
}

// O and lse from two splits' partial results (po: 2 x rows x D, plse: 2 x
// rows): lse = log(e^lse0 + e^lse1), O = e^(lse0 - lse) O0 + e^(lse1 - lse)
// O1. One warp a row, float4 steps along D. O is stored in T, and where
// that rounds (bf16), in fp32 to o32 too.
template <typename T>
__global__ void attn_combine_kernel(const float* __restrict__ po,
                                    const float* __restrict__ plse,
                                    T* __restrict__ o, float* __restrict__ lse,
                                    int rows, int D, float* __restrict__ o32) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float l0 = plse[row], l1 = plse[rows + row];
  const float m = fmaxf(l0, l1);
  const float e0 = expf(l0 - m), e1 = expf(l1 - m), sum = e0 + e1;
  const float w0 = e0 / sum, w1 = e1 / sum;
  const float4* a = reinterpret_cast<const float4*>(po + (size_t)row * D);
  const float4* c =
      reinterpret_cast<const float4*>(po + ((size_t)rows + row) * D);
  T* out = o + (size_t)row * D;
  float4* out32 = reinterpret_cast<float4*>(o32 + (size_t)row * D);
  for (int i = lane; i < D / 4; i += 32) {
    const float4 x = a[i], y = c[i];
    const float4 r =
        make_float4(fmaf(w1, y.x, w0 * x.x), fmaf(w1, y.y, w0 * x.y),
                    fmaf(w1, y.z, w0 * x.z), fmaf(w1, y.w, w0 * x.w));
    if constexpr (std::is_same<T, float>::value) {
      reinterpret_cast<float4*>(out)[i] = r;
    } else {
      store4(out + 4 * i, r);
      out32[i] = r;
    }
  }
  if (lane == 0) lse[row] = m + logf(sum);
}

// ---------------------------------------------------------------- K5b ---
// delta[row] = sum_d dO[row][d] * O[row][d], O the forward's fp32 output:
// one warp per row, lanes over D in float4 steps, then a butterfly sum
// (every lane holds the same bits).
template <typename T>
__global__ void attn_delta_kernel(const float* __restrict__ o,
                                  const T* __restrict__ dout,
                                  float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float4* a = reinterpret_cast<const float4*>(o + (size_t)row * D);
  const T* g = dout + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D / 4; c += 32) {
    const float4 x = a[c], y = load4(g + 4 * c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// S^T and dP^T for one tile of 128 keys x 128 q rows: 8 warps, 32 x 64 a
// warp (2 x 8 fragments). (K, Q) chunks 32 deep in D form S^T, then (V, dO)
// chunks dP^T, each stage of the ring holding two 128 x 32 chunks. Writes
// P^T = exp(scale S^T - lse) to the scratch after the first pass and reads
// it back (each thread its own entries) for dS^T = P^T o (dP^T - delta)
// after the second; key-major, B x Np x Np each, 0 past N.
constexpr int kSStage = 2 * kScoreTile * kLdS;  // a (K or V, Q or dO) pair

template <typename T>
__device__ __forceinline__ void scores_pass(float (&acc)[2][kGFrag][4],
                                            const T* As, const T* Bs, int wm,
                                            int wn, int g, int t) {
  float part[2][kGFrag][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) zero(part[mi]);
#pragma unroll
  for (int ks = 0; ks < kSK / 8; ++ks) {
    const int k = 8 * ks + 2 * t;
    uint32_t bh[kGFrag][2], bl[kGFrag][2];
#pragma unroll
    for (int nj = 0; nj < kGFrag; ++nj) {
      const float2 v = ld2(Bs + (wn + 8 * nj + g) * kLdS + k);
      operand<T>(v.x, bh[nj][0], bl[nj][0]);
      operand<T>(v.y, bh[nj][1], bl[nj][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + 16 * mi + g;
      const float2 x = ld2(As + r * kLdS + k);
      const float2 y = ld2(As + (r + 8) * kLdS + k);
      uint32_t ah[4], al[4];
      operand<T>(x.x, ah[0], al[0]);
      operand<T>(y.x, ah[1], al[1]);
      operand<T>(x.y, ah[2], al[2]);
      operand<T>(y.y, ah[3], al[3]);
      mma_terms<kSplit<T>, kSplit<T>>(part[mi], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) add_to(acc[mi], part[mi]);
}

template <typename T>
__global__ void __launch_bounds__(kGThreads, 1)
    attn_scores_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ pt_out,
                          float* __restrict__ dst_out, int N, int D, int Np,
                          float scale) {
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  const int nc = (D + kSK - 1) / kSK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 32 * (warp / 2), wn = 8 * kGFrag * (warp % 2);
  const int q0 = blockIdx.x * kScoreTile, k0 = blockIdx.y * kScoreTile;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * N * D, row0 = (size_t)b * N;
  auto stage = [&](int j) { return ring + (j % kStages) * kSStage; };
  // (K, Q) chunks, then (V, dO) chunks
  auto issue = [&](int j) {
    if (j < 2 * nc) {
      const int pass = j / nc, c0 = (j - pass * nc) * kSK;
      load_box<kScoreTile, kSK, kGThreads>(stage(j), kLdS,
                                           (pass ? v : k) + base, D, k0, c0,
                                           N, D);
      load_box<kScoreTile, kSK, kGThreads>(stage(j) + kScoreTile * kLdS, kLdS,
                                           (pass ? dout : q) + base, D, q0,
                                           c0, N, D);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  float acc[2][kGFrag][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) zero(acc[mi]);
  int j = 0;
  for (; j < nc; ++j) {
    ring_step(j, issue);
    scores_pass(acc, stage(j), stage(j) + kScoreTile * kLdS, wm, wn, g, t);
  }
  // P^T, zero past N
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + wm + 16 * mi + g + 8 * h;
#pragma unroll
      for (int nj = 0; nj < kGFrag; ++nj) {
        const int qq = q0 + wn + 8 * nj + 2 * t;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p[e] = key < N && qq + e < N
                     ? expf(acc[mi][nj][2 * h + e] * scale - lse[row0 + qq + e])
                     : 0.f;
        *reinterpret_cast<float2*>(pt_out + ((size_t)b * Np + key) * Np +
                                   qq) = make_float2(p[0], p[1]);
      }
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) zero(acc[mi]);
  for (; j < 2 * nc; ++j) {
    ring_step(j, issue);
    scores_pass(acc, stage(j), stage(j) + kScoreTile * kLdS, wm, wn, g, t);
  }
  cp_async_wait<0>();
  // dS^T = P^T o (dP^T - delta[q]), P^T read back from this thread's writes
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + wm + 16 * mi + g + 8 * h;
#pragma unroll
      for (int nj = 0; nj < kGFrag; ++nj) {
        const int qq = q0 + wn + 8 * nj + 2 * t;
        const size_t at = ((size_t)b * Np + key) * Np + qq;
        const float2 p = *reinterpret_cast<const float2*>(pt_out + at);
        const float d0 = qq < N ? delta[row0 + qq] : 0.f;
        const float d1 = qq + 1 < N ? delta[row0 + qq + 1] : 0.f;
        *reinterpret_cast<float2*>(dst_out + at) =
            make_float2(p.x * (acc[mi][nj][2 * h] - d0),
                        p.y * (acc[mi][nj][2 * h + 1] - d1));
      }
    }
}

// The products over the scratch, a tiled GEMM a batch element: out = scale
// A M, A(r, c) = s[c][r] (TRANS: dQ = scale dS K, from the key-major dS^T)
// or s[r][c] (dK = scale dS^T Q, dV = P^T dO); M = K, Q or dO (N x D, of
// storage type T, as out). A block of 8 warps owns 128 rows x 128 columns
// of out (32 x 64 a warp: 2 x 8 fragments, so each k8 step splits 8 A and
// 16 B values for 48 mma in fp32; 16 warps of 32 x 32 were slower) and
// streams 32-deep chunks of A and M through a 3-stage ring, each chunk's
// sum added to the running sum with a rounded fp32 add (the design note
// above). A's chunk is s's rows (TRANS, row stride 132 = 4 mod 32, read as
// a "pair" A) or columns (row stride 40 = 8 mod 32, a float2 a fragment
// pair), M's chunk rows of c (row stride Ld<T>::m). Splitting both chunks
// once a block into hi/lo planes, instead of in each warp's registers, was
// slower (twice the shared-memory reads).
template <typename T>  // a stage, in floats: the A region (the larger) + M
constexpr int kGStage =
    kGR * kLdA + kGK * Ld<T>::m * sizeof(T) / sizeof(float);

template <bool TRANS, typename T>
__device__ __forceinline__ void scratch_gemm(const T* __restrict__ m,
                                             const float* __restrict__ sc,
                                             T* __restrict__ out, int N,
                                             int D, int Np, float scale) {
  constexpr int ldm = Ld<T>::m;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kGN, r0 = blockIdx.y * kGR, b = blockIdx.z;
  const int wm = 32 * (warp / 2), wn = 8 * kGFrag * (warp % 2);
  const size_t base = (size_t)b * N * D;
  const T* mb = m + base;
  const float* sb = sc + (size_t)b * Np * Np;
  const int total = (N + kGK - 1) / kGK;
  auto stage = [&](int j) {
    return ring + (j % kStages) * kGStage<T>;
  };
  auto mchunk = [&](float* st) { return reinterpret_cast<T*>(st + kGR * kLdA); };
  auto issue = [&](int j) {
    if (j < total) {
      float* st = stage(j);
      if (TRANS)
        load_box<kGK, kGR, kGThreads>(st, kLdT, sb, Np, j * kGK, r0, N, N);
      else
        load_box<kGR, kGK, kGThreads>(st, kLdA, sb, Np, r0, j * kGK, N, N);
      load_box<kGK, kGN, kGThreads>(mchunk(st), ldm, mb, D, j * kGK, n0, N,
                                    D);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  float acc[2][kGFrag][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) zero(acc[mi]);
  for (int j = 0; j < total; ++j) {
    ring_step(j, issue);
    const float* As = stage(j);
    const T* Bs = reinterpret_cast<const T*>(As + kGR * kLdA);
    float part[2][kGFrag][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) zero(part[mi]);
#pragma unroll
    for (int ks = 0; ks < kGK / 8; ++ks) {
      const int k = 8 * ks + 2 * t;
      uint32_t bh[kGFrag][2], bl[kGFrag][2];
#pragma unroll
      for (int nj = 0; nj < kGFrag; ++nj) {
        operand<T>(ld1(Bs + k * ldm + wn + 8 * nj + g), bh[nj][0], bl[nj][0]);
        operand<T>(ld1(Bs + (k + 1) * ldm + wn + 8 * nj + g), bh[nj][1],
                   bl[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + 16 * mi + g;
        float a[4];
        if (TRANS) {
          a[0] = As[k * kLdT + r];
          a[1] = As[k * kLdT + r + 8];
          a[2] = As[(k + 1) * kLdT + r];
          a[3] = As[(k + 1) * kLdT + r + 8];
        } else {
          const float2 x = *reinterpret_cast<const float2*>(As + r * kLdA + k);
          const float2 y =
              *reinterpret_cast<const float2*>(As + (r + 8) * kLdA + k);
          a[0] = x.x, a[1] = y.x, a[2] = x.y, a[3] = y.y;
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
        mma_terms<true, kSplit<T>>(part[mi], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) add_to(acc[mi], part[mi]);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm + 16 * mi + g + 8 * h;
      if (row >= N) continue;
#pragma unroll
      for (int nj = 0; nj < kGFrag; ++nj) {
        const int n = n0 + wn + 8 * nj + 2 * t;
        if (n < D)
          st2(out + base + (size_t)row * D + n, acc[mi][nj][2 * h] * scale,
              acc[mi][nj][2 * h + 1] * scale);
      }
    }
}

// dV = P^T dO.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 1)
    attn_dv_tc_kernel(const T* __restrict__ dout, const float* __restrict__ pt,
                      T* __restrict__ dv, int N, int D, int Np, float scale) {
  scratch_gemm<false>(dout, pt, dv, N, D, Np, scale);
}

// dK = scale dS^T Q.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 1)
    attn_dk_tc_kernel(const T* __restrict__ q, const float* __restrict__ ds,
                      T* __restrict__ dk, int N, int D, int Np, float scale) {
  scratch_gemm<false>(q, ds, dk, N, D, Np, scale);
}

// dQ = scale dS K.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 1)
    attn_dq_tc_kernel(const T* __restrict__ k, const float* __restrict__ ds,
                      T* __restrict__ dq, int N, int D, int Np, float scale) {
  scratch_gemm<true>(k, ds, dq, N, D, Np, scale);
}

// ----------------------------------------------------------------- host --
int padded_d(int D) { return (D + kC - 1) / kC * kC; }

template <typename T>
size_t fwd_smem(int D) {
  return sizeof(T) * ((size_t)kBQ * (padded_d(D) + 8) + kStages * kSlot) +
         sizeof(float) * (2 * kBQ * kLdp + 2 * (8 / (kBQ / 16)) * kBQ);
}
template <typename T>
size_t scores_smem() {
  return sizeof(T) * kStages * kSStage;
}
template <typename T>
size_t gemm_smem() {
  return sizeof(float) * kStages * kGStage<T>;
}

// One of the products over the scratch: dV, dK or dQ.
template <typename Kernel, typename T>
cudaError_t launch_gemm(Kernel kernel, size_t smem, dim3 grid, const T* m,
                        const float* scratch, T* out, int N, int D, int Np,
                        float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGThreads, smem, stream>>>(m, scratch, out, N, D, Np, scale);
  return cudaGetLastError();
}

// dV, dK and dQ from the P^T and dS^T scratch.
template <typename T>
cudaError_t launch_products(const T* q, const T* k, const T* dout,
                            const float* pt, const float* dst, T* dq, T* dk,
                            T* dv, int B, int N, int D, int Np, float scale,
                            cudaStream_t stream) {
  const size_t smem = gemm_smem<T>();
  const dim3 grid((D + kGN - 1) / kGN, (N + kGR - 1) / kGR, B);
  cudaError_t err = launch_gemm(attn_dv_tc_kernel<T>, smem, grid, dout, pt,
                                dv, N, D, Np, 1.f, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm(attn_dk_tc_kernel<T>, smem, grid, q, dst, dk, N, D, Np,
                    scale, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm(attn_dq_tc_kernel<T>, smem, grid, k, dst, dq, N, D, Np,
                     scale, stream);
}

template <typename T, typename TO>
cudaError_t launch_fwd(const T* q, const T* k, const T* v, TO* o, float* lse,
                       float* o32, int B, int N, int D, float scale,
                       int splits, cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_tc_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attn_fwd_tc_kernel<T, TO><<<dim3((N + kBQ - 1) / kBQ, B, splits), kThreads,
                              smem, stream>>>(q, k, v, o, lse, N, D, scale,
                                              o32);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_fwd(const T* q, const T* k, const T* v, T* o,
                          float* lse, float* part, float* o32, int B, int N,
                          int D, float scale, int splits,
                          cudaStream_t stream) {
  const int tiles = (N + kBK - 1) / kBK;
  if (splits > tiles) splits = tiles;
  if (splits < 1 || splits > 2 || (splits == 2 && part == nullptr) ||
      (!std::is_same<T, float>::value && o32 == nullptr))
    return cudaErrorInvalidValue;
  if (splits == 1) return launch_fwd(q, k, v, o, lse, o32, B, N, D, scale, 1,
                                     stream);
  float* plse = part + (size_t)2 * B * N * D;
  cudaError_t err =
      launch_fwd(q, k, v, part, plse, nullptr, B, N, D, scale, 2, stream);
  if (err != cudaSuccess) return err;
  const int rows = B * N, per_block = kThreads / 32;
  attn_combine_kernel<T><<<(rows + per_block - 1) / per_block, kThreads, 0,
                           stream>>>(part, plse, o, lse, rows, D, o32);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_bwd(const T* q, const T* k, const T* v, const float* o,
                          const float* lse, const T* dout, float* delta,
                          float* ds, T* dq, T* dk, T* dv, int B, int N, int D,
                          float scale, cudaStream_t stream) {
  const int rows = B * N, per_block = kThreads / 32;
  const int Np = (N + kScoreTile - 1) / kScoreTile * kScoreTile;
  attn_delta_kernel<T><<<(rows + per_block - 1) / per_block, kThreads, 0,
                         stream>>>(o, dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t s_sc = scores_smem<T>();
  err = cudaFuncSetAttribute(attn_scores_tc_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_sc));
  if (err != cudaSuccess) return err;
  const int tiles = (N + kScoreTile - 1) / kScoreTile;
  float* pt = ds + (size_t)B * Np * Np;
  attn_scores_tc_kernel<T><<<dim3(tiles, tiles, B), kGThreads, s_sc, stream>>>(
      q, k, v, dout, lse, delta, pt, ds, N, D, Np, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_products(q, k, dout, pt, ds, dq, dk, dv, B, N, D, Np, scale,
                         stream);
}

}  // namespace

// q, k, v, o: (B, N, D), fp32 (is_bf16 = 0) or bf16, contiguous, 16-byte
// aligned; D % 4 == 0 (bf16: D % 8 == 0), 4 <= D <= 512. lse: (B, N), the
// row log-sum-exp of scale * Q K^T. splits: the key tiles (64 keys) cut
// into 1 or 2 ranges, each a block of its own, merged by
// attn_combine_kernel (more blocks where B N / 64 would leave SMs idle); at
// most one range a tile. part: 2 B N (D + 1) floats of scratch for 2
// splits, else unused. o32: (B, N, D) fp32, the unrounded O, for bf16 (the
// backward's delta reads it); unused in fp32, where o is that O.
extern "C" cudaError_t uig_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         float* part, float* o32, int B,
                                         int N, int D, float scale,
                                         int splits, int is_bf16,
                                         cudaStream_t stream) {
  if (is_bf16)
    return attention_fwd(static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<bf16*>(o),
                         lse, part, o32, B, N, D, scale, splits, stream);
  return attention_fwd(static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<float*>(o),
                       lse, part, nullptr, B, N, D, scale, splits, stream);
}

// dout: (B, N, D) the gradient of o; o32 (fp32: o; bf16: o32) and lse from
// uig_attention_fwd. delta: (B, N) scratch; ds: (2, B, Np, Np) scratch,
// dS^T then P^T, Np = N rounded up to a multiple of 128. dq, dk, dv:
// (B, N, D) outputs in the storage type of q, k, v and dout.
extern "C" cudaError_t uig_attention_bwd(const void* q, const void* k,
                                         const void* v, const float* o32,
                                         const float* lse, const void* dout,
                                         float* delta, float* ds, void* dq,
                                         void* dk, void* dv, int B, int N,
                                         int D, float scale, int is_bf16,
                                         cudaStream_t stream) {
  if (is_bf16)
    return attention_bwd(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), o32, lse, static_cast<const bf16*>(dout),
        delta, ds, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), B, N, D, scale, stream);
  return attention_bwd(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), o32, lse,
      static_cast<const float*>(dout), delta, ds, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), B, N, D, scale,
      stream);
}
