// Single-head attention over (B, N, D) fp32: the forward (K5f) and its
// backward (K5b).
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
// Bound on this card: operations. The forward is two products of 2 B N^2 D
// flops each (0.256 ms at (8, 1024, 512) at 67 TFLOP/s fp32, H100 SXM data
// sheet at 700 W); the backward five (0.641 ms). The bytes (q, k, v, o, dO
// and the gradients, ~67 MB at B = 8) take 0.02 ms. fp32 FMAs only, no TF32:
// the serving path is fp32 "highest".
//
// Design. A block's 227 KB of shared memory cannot hold K and V, so a block
// owns a tile of 32 q rows (or 16 k rows) and streams the other side's tiles
// through shared memory; the (N, N) scores never reach device memory.
//   * Forward (attn_fwd_kernel): an online softmax. Per K tile of 32 rows the
//     block forms the 32 x 32 scores, updates each row's running max and sum,
//     rescales its O accumulator (32 x D in registers, 16 rows x float4 a
//     thread at D = 512), and adds P V from the V tile loaded into the same
//     buffer. It writes O = acc / sum and the row log-sum-exp (B, N), the
//     residual of the backward.
//   * Backward, the FlashAttention-2 shape without atomics, so every sum runs
//     in a fixed order and a step repeats bit for bit: attn_delta_kernel
//     forms rowsum(dO o O) (= rowsum(P o dP)); attn_dkdv_kernel owns 16 k rows
//     and loops over every q tile to form dK and dV; attn_dq_kernel owns 32 q
//     rows and loops over every k tile to form dQ. Both recompute P from the
//     log-sum-exp, so the backward does seven products where five suffice.
//   * Score tiles (score_tile): four D-slices of 64 threads, each thread a
//     4 x (BC/8) micro tile at rows mi + 8a, columns mj + 8b (float4 loads
//     along D; rows padded to D + 4 floats, so eight rows fall in eight
//     different 16-byte bank groups), then the four partials are summed in
//     slice order.
//   * Wide products (wide_acc): a thread owns one float4 column group of D
//     and every (256 / (D/4))-th row, and sums over the tile in order.
// Ragged N: rows past N load as zeros, their scores are masked to -inf (P =
// 0), and their outputs are not stored.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;       // q rows of a tile
constexpr int kBKf = 32;      // k rows of a tile, forward
constexpr int kBKb = 16;      // k rows of a tile, backward
constexpr int kSlices = 4;    // D-slices of a score tile
constexpr int kMaxRows = 16;  // accumulator rows a thread owns (D <= 512)

// rows [r0, r0 + R) of an (N, D) matrix into shared memory with row stride
// D + 4; rows at or past N are zeros.
__device__ void load_rows(float* s, const float* g, int r0, int R, int N,
                          int D) {
  const int d4 = D / 4, ld = D + 4;
  for (int e = threadIdx.x; e < R * d4; e += kThreads) {
    const int r = e / d4, c = e - r * d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N)
      v = reinterpret_cast<const float4*>(g + (size_t)(r0 + r) * D)[c];
    *reinterpret_cast<float4*>(s + r * ld + 4 * c) = v;
  }
}

// out[i * ldo + j] = sum_d A[i][d] * B[j][d] for i < 32, j < BC; A and B in
// shared memory with row stride D + 4. Ends with a barrier.
template <int BC>
__device__ void score_tile(const float* A, const float* B, float* red,
                           float* out, int ldo, int D) {
  constexpr int MC = BC / 8;
  const int ld = D + 4, d4 = D / 4;
  const int t = threadIdx.x, s = t / 64, m = t % 64, mi = m / 8, mj = m % 8;
  float acc[4][MC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b) acc[a][b] = 0.f;
  for (int k = s; k < d4; k += kSlices) {
    float4 av[4], bv[MC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (mi + 8 * a) * ld + 4 * k);
#pragma unroll
    for (int b = 0; b < MC; ++b)
      bv[b] = *reinterpret_cast<const float4*>(B + (mj + 8 * b) * ld + 4 * k);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < MC; ++b) {
        float c = acc[a][b];
        c = fmaf(av[a].x, bv[b].x, c);
        c = fmaf(av[a].y, bv[b].y, c);
        c = fmaf(av[a].z, bv[b].z, c);
        c = fmaf(av[a].w, bv[b].w, c);
        acc[a][b] = c;
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b)
      red[(s * kBQ + mi + 8 * a) * BC + mj + 8 * b] = acc[a][b];
  __syncthreads();
  for (int e = t; e < kBQ * BC; e += kThreads) {
    const int i = e / BC, j = e - i * BC;
    float v = red[i * BC + j];
#pragma unroll
    for (int s2 = 1; s2 < kSlices; ++s2) v += red[(s2 * kBQ + i) * BC + j];
    out[i * ldo + j] = v;
  }
  __syncthreads();
}

// The rows and float4 column group of D that a thread accumulates.
struct Wide {
  int cg, rg, RG;
  bool active;
};

__device__ Wide wide_of(int D) {
  const int cgs = D / 4, RG = kThreads / cgs;
  const int t = threadIdx.x;
  return Wide{t % cgs, t / cgs, RG, t < RG * cgs};
}

// acc[u] += sum_{j < J} C[r * ldc + j] * M[j][4 cg .. 4 cg + 3] for the
// thread's rows r = rg + RG u < R, summed over j in order. U >= R / RG.
template <int U>
__device__ void wide_acc(float4 (&acc)[U], const float* C, int ldc,
                         const float* M, int J, int R, int D, Wide w) {
  if (!w.active) return;
  const int ld = D + 4;
  for (int j = 0; j < J; ++j) {
    const float4 mv = *reinterpret_cast<const float4*>(M + j * ld + 4 * w.cg);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = w.rg + w.RG * u;
      if (r < R) {
        const float c = C[r * ldc + j];
        acc[u].x = fmaf(c, mv.x, acc[u].x);
        acc[u].y = fmaf(c, mv.y, acc[u].y);
        acc[u].z = fmaf(c, mv.z, acc[u].z);
        acc[u].w = fmaf(c, mv.w, acc[u].w);
      }
    }
  }
}

template <int U>
__device__ void store_rows(float* g, const float4 (&acc)[U], int r0,
                           int R, int N, int D, float mul, Wide w) {
  if (!w.active) return;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = w.rg + w.RG * u;
    if (r < R && r0 + r < N) {
      const float4 a = acc[u];
      reinterpret_cast<float4*>(g + (size_t)(r0 + r) * D)[w.cg] =
          make_float4(a.x * mul, a.y * mul, a.z * mul, a.w * mul);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = D + 4, ldp = kBKf + 1;
  float* sQ = reinterpret_cast<float*>(smem4);  // kBQ x ld
  float* sKV = sQ + kBQ * ld;                   // kBKf x ld: K, then V
  float* red = sKV + kBKf * ld;                 // kSlices x kBQ x kBKf
  float* sS = red + kSlices * kBQ * kBKf;       // kBQ x ldp: scores, then P
  float* sM = sS + kBQ * ldp;                   // running row max
  float* sL = sM + kBQ;                         // running row sum
  float* sA = sL + kBQ;                         // this tile's rescale
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ, t = threadIdx.x;
  const size_t base = (size_t)b * N * D;
  load_rows(sQ, q + base, q0, kBQ, N, D);
  if (t < kBQ) {
    sM[t] = -INFINITY;
    sL[t] = 0.f;
  }
  const Wide w = wide_of(D);
  float4 acc[kMaxRows];
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int warp = t / 32, lane = t % 32;
  for (int k0 = 0; k0 < N; k0 += kBKf) {
    __syncthreads();  // the previous V tile is consumed
    load_rows(sKV, k + base, k0, kBKf, N, D);
    __syncthreads();
    score_tile<kBKf>(sQ, sKV, red, sS, ldp, D);
    // online softmax: warp w updates rows 4w .. 4w + 3, lane = column
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int i = warp * (kBQ / 8) + rr;
      const float m_old = sM[i];
      const float s = (k0 + lane < N) ? sS[i * ldp + lane] * scale : -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sS[i * ldp + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[i] = alpha;
        sL[i] = sL[i] * alpha + sum;
        sM[i] = m_new;
      }
    }
    __syncthreads();  // P and the rescales are ready; K is no longer read
    load_rows(sKV, v + base, k0, kBKf, N, D);
    __syncthreads();
    if (w.active) {
#pragma unroll
      for (int u = 0; u < kMaxRows; ++u) {
        const int r = w.rg + w.RG * u;
        if (r < kBQ) {
          const float a = sA[r];
          acc[u] = make_float4(acc[u].x * a, acc[u].y * a, acc[u].z * a,
                               acc[u].w * a);
        }
      }
    }
    wide_acc(acc, sS, ldp, sKV, kBKf, kBQ, D, w);
  }
  if (w.active) {
#pragma unroll
    for (int u = 0; u < kMaxRows; ++u) {
      const int r = w.rg + w.RG * u;
      if (r < kBQ && q0 + r < N) {
        const float l = sL[r];
        const float4 a = acc[u];
        reinterpret_cast<float4*>(o + base + (size_t)(q0 + r) * D)[w.cg] =
            make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
      }
    }
  }
  if (t < kBQ && q0 + t < N) lse[(size_t)b * N + q0 + t] = sM[t] + logf(sL[t]);
}

// delta[row] = sum_d dO[row][d] * O[row][d]: one warp per row, lanes over D
// in float4 steps, then a butterfly sum (every lane holds the same bits).
__global__ void attn_delta_kernel(const float* __restrict__ o,
                                  const float* __restrict__ dout,
                                  float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float4* a = reinterpret_cast<const float4*>(o + (size_t)row * D);
  const float4* g = reinterpret_cast<const float4*>(dout + (size_t)row * D);
  float s = 0.f;
  for (int c = lane; c < D / 4; c += 32) {
    const float4 x = a[c], y = g[c];
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

// The per-q-row residuals of a q tile (past N: lse 0, delta 0).
__device__ void load_row_stats(float* sLse, float* sDelta, const float* lse,
                               const float* delta, size_t row0, int q0,
                               int N) {
  const int t = threadIdx.x;
  if (t < kBQ) {
    const bool in = q0 + t < N;
    sLse[t] = in ? lse[row0 + q0 + t] : 0.f;
    sDelta[t] = in ? delta[row0 + q0 + t] : 0.f;
  }
}

// One block per 16 k rows: loops over every q tile, dK and dV in registers.
__global__ void __launch_bounds__(kThreads, 1)
    attn_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = D + 4, lds = kBKb + 1, ldt = kBQ + 1;
  float* sK = reinterpret_cast<float*>(smem4);  // kBKb x ld
  float* sV = sK + kBKb * ld;                   // kBKb x ld
  float* sQ = sV + kBKb * ld;                   // kBQ x ld
  float* sdO = sQ + kBQ * ld;                   // kBQ x ld
  float* red = sdO + kBQ * ld;                  // kSlices x kBQ x kBKb
  float* sS = red + kSlices * kBQ * kBKb;       // kBQ x lds: Q K^T
  float* sDP = sS + kBQ * lds;                  // kBQ x lds: dO V^T
  float* sPT = sDP + kBQ * lds;                 // kBKb x ldt: P^T
  float* sDST = sPT + kBKb * ldt;               // kBKb x ldt: dS^T
  float* sLse = sDST + kBKb * ldt;              // kBQ
  float* sDelta = sLse + kBQ;                   // kBQ
  const int b = blockIdx.y, k0 = blockIdx.x * kBKb;
  const size_t base = (size_t)b * N * D, row0 = (size_t)b * N;
  load_rows(sK, k + base, k0, kBKb, N, D);
  load_rows(sV, v + base, k0, kBKb, N, D);
  const Wide w = wide_of(D);
  float4 acc_dk[kMaxRows / 2], acc_dv[kMaxRows / 2];  // 16 rows, RG >= 2
#pragma unroll
  for (int u = 0; u < kMaxRows / 2; ++u) {
    acc_dk[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_dv[u] = acc_dk[u];
  }
  for (int q0 = 0; q0 < N; q0 += kBQ) {
    __syncthreads();  // the previous q tile is consumed
    load_rows(sQ, q + base, q0, kBQ, N, D);
    load_rows(sdO, dout + base, q0, kBQ, N, D);
    load_row_stats(sLse, sDelta, lse, delta, row0, q0, N);
    __syncthreads();
    score_tile<kBKb>(sQ, sK, red, sS, lds, D);
    score_tile<kBKb>(sdO, sV, red, sDP, lds, D);
    for (int e = threadIdx.x; e < kBQ * kBKb; e += kThreads) {
      const int i = e / kBKb, j = e - i * kBKb;
      const bool in = q0 + i < N && k0 + j < N;
      const float p = in ? expf(sS[i * lds + j] * scale - sLse[i]) : 0.f;
      sPT[j * ldt + i] = p;
      sDST[j * ldt + i] = p * (sDP[i * lds + j] - sDelta[i]);
    }
    __syncthreads();
    wide_acc(acc_dv, sPT, ldt, sdO, kBQ, kBKb, D, w);
    wide_acc(acc_dk, sDST, ldt, sQ, kBQ, kBKb, D, w);
  }
  store_rows(dk + base, acc_dk, k0, kBKb, N, D, scale, w);
  store_rows(dv + base, acc_dv, k0, kBKb, N, D, 1.f, w);
}

// One block per 32 q rows: loops over every k tile, dQ in registers.
__global__ void __launch_bounds__(kThreads, 1)
    attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int N, int D, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = D + 4, lds = kBKb + 1;
  float* sQ = reinterpret_cast<float*>(smem4);  // kBQ x ld
  float* sdO = sQ + kBQ * ld;                   // kBQ x ld
  float* sK = sdO + kBQ * ld;                   // kBKb x ld
  float* sV = sK + kBKb * ld;                   // kBKb x ld
  float* red = sV + kBKb * ld;                  // kSlices x kBQ x kBKb
  float* sS = red + kSlices * kBQ * kBKb;       // kBQ x lds: Q K^T, then dS
  float* sDP = sS + kBQ * lds;                  // kBQ x lds: dO V^T
  float* sLse = sDP + kBQ * lds;                // kBQ
  float* sDelta = sLse + kBQ;                   // kBQ
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)b * N * D, row0 = (size_t)b * N;
  load_rows(sQ, q + base, q0, kBQ, N, D);
  load_rows(sdO, dout + base, q0, kBQ, N, D);
  load_row_stats(sLse, sDelta, lse, delta, row0, q0, N);
  const Wide w = wide_of(D);
  float4 acc[kMaxRows];
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < N; k0 += kBKb) {
    __syncthreads();  // the previous k tile is consumed
    load_rows(sK, k + base, k0, kBKb, N, D);
    load_rows(sV, v + base, k0, kBKb, N, D);
    __syncthreads();
    score_tile<kBKb>(sQ, sK, red, sS, lds, D);
    score_tile<kBKb>(sdO, sV, red, sDP, lds, D);
    for (int e = threadIdx.x; e < kBQ * kBKb; e += kThreads) {
      const int i = e / kBKb, j = e - i * kBKb;
      const bool in = q0 + i < N && k0 + j < N;
      const float p = in ? expf(sS[i * lds + j] * scale - sLse[i]) : 0.f;
      sS[i * lds + j] = p * (sDP[i * lds + j] - sDelta[i]);
    }
    __syncthreads();
    wide_acc(acc, sS, lds, sK, kBKb, kBQ, D, w);
  }
  store_rows(dq + base, acc, q0, kBQ, N, D, scale, w);
}

size_t fwd_smem(int D) {
  const size_t ld = D + 4;
  return sizeof(float) * (2 * kBQ * ld + kSlices * kBQ * kBKf +
                          kBQ * (kBKf + 1) + 3 * kBQ);
}

size_t dkdv_smem(int D) {
  const size_t ld = D + 4;
  return sizeof(float) * (2 * kBKb * ld + 2 * kBQ * ld +
                          kSlices * kBQ * kBKb + 2 * kBQ * (kBKb + 1) +
                          2 * kBKb * (kBQ + 1) + 2 * kBQ);
}

size_t dq_smem(int D) {
  const size_t ld = D + 4;
  return sizeof(float) * (2 * kBQ * ld + 2 * kBKb * ld +
                          kSlices * kBQ * kBKb + 2 * kBQ * (kBKb + 1) +
                          2 * kBQ);
}

}  // namespace

// q, k, v, o: (B, N, D) fp32, contiguous, 16-byte aligned; D % 4 == 0,
// 4 <= D <= 512. lse: (B, N), the row log-sum-exp of scale * Q K^T.
extern "C" cudaError_t uig_attention_fwd(const float* q, const float* k,
                                         const float* v, float* o, float* lse,
                                         int B, int N, int D, float scale,
                                         cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<<<dim3((N + kBQ - 1) / kBQ, B), kThreads, smem, stream>>>(
      q, k, v, o, lse, N, D, scale);
  return cudaGetLastError();
}

// dout: (B, N, D) the gradient of o; o and lse from uig_attention_fwd.
// delta: (B, N) scratch. dq, dk, dv: (B, N, D) outputs.
extern "C" cudaError_t uig_attention_bwd(const float* q, const float* k,
                                         const float* v, const float* o,
                                         const float* lse, const float* dout,
                                         float* delta, float* dq, float* dk,
                                         float* dv, int B, int N, int D,
                                         float scale, cudaStream_t stream) {
  const int rows = B * N, per_block = kThreads / 32;
  attn_delta_kernel<<<(rows + per_block - 1) / per_block, kThreads, 0,
                      stream>>>(o, dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t s_kv = dkdv_smem(D), s_q = dq_smem(D);
  err = cudaFuncSetAttribute(attn_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_q));
  if (err != cudaSuccess) return err;
  attn_dkdv_kernel<<<dim3((N + kBKb - 1) / kBKb, B), kThreads, s_kv,
                     stream>>>(q, k, v, dout, lse, delta, dk, dv, N, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dq_kernel<<<dim3((N + kBQ - 1) / kBQ, B), kThreads, s_q, stream>>>(
      q, k, v, dout, lse, delta, dq, N, D, scale);
  return cudaGetLastError();
}
