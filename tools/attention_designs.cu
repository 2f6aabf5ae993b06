// The attention backward in FlashAttention-2's shape, the design that
// src/uig_torch/csrc/attention.cu's scores kernel and three GEMMs replaced;
// tools/attention_designs.py builds it beside that file and times the two.
// It is on no path of the port.
//
// attn_dkdv_tc_kernel: a block owns 32 keys, their K and V rows resident in
// shared memory, and walks the q tiles of 64 rows in order. Per tile it
// forms S^T = K Q^T and dP^T = V dO^T over D-chunks of Q and dO from the
// ring, takes P^T = exp(scale S^T - lse) and dS^T = P^T o (dP^T - delta),
// writes dS^T to a key-major B x Np x Np scratch (half of the scores
// design's), keeps both as hi/lo planes, and adds dV += P^T dO and dK +=
// dS^T Q over D-chunks of dO and Q streamed again, into registers (a warp
// owns 16 keys x 16 columns of each 64-column chunk: 2 x 64 accumulator
// floats a thread at D = 512, which is why a block holds 32 keys and not
// 64). dQ = scale dS K is attention.cu's attn_dq_tc_kernel over the
// scratch. Five products, the same split, the same rounded fp32 adds of
// 64-deep partial sums, the same fixed order.
#include "attention.cu"

namespace {

constexpr int kKB = 32;  // keys a block
constexpr int kQB = 64;  // q rows a step

__global__ void __launch_bounds__(kThreads, 1)
    attn_dkdv_tc_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dst_out, float* __restrict__ dk,
                        float* __restrict__ dv, int N, int D, int Np,
                        float scale) {
  extern __shared__ float4 smem4[];
  const int nc = (D + kC - 1) / kC, ldk = nc * kC + 8;
  float* sK = reinterpret_cast<float*>(smem4);  // kKB x ldk
  float* sV = sK + kKB * ldk;
  float* ring = sV + kKB * ldk;          // kStages x kSlot
  float* pHi = ring + kStages * kSlot;  // kKB x kLdp each: P^T, dS^T
  float* pLo = pHi + kKB * kLdp;
  float* dHi = pLo + kKB * kLdp;
  float* dLo = dHi + kKB * kLdp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp / 4, wc = warp % 4;
  const int b = blockIdx.y, k0 = blockIdx.x * kKB, r0 = 16 * wr;
  const size_t base = (size_t)b * N * D, row0 = (size_t)b * N;
  // per q tile: Q chunks (S^T) and dO chunks (dP^T) as "row" B, then dO
  // chunks (dV) and Q chunks (dK) as "pair" B
  const int per_tile = 4 * nc, total = (N + kQB - 1) / kQB * per_tile;
  auto slot = [&](int j) { return ring + (j % kStages) * kSlot; };
  auto issue = [&](int j) {
    if (j < total) {
      const int qt = j / per_tile, r = j - qt * per_tile;
      const int phase = r / nc, dc = r - phase * nc;
      const float* m = phase == 0 || phase == 3 ? q : dout;
      load_box<kC, kC, kThreads>(slot(j), phase < 2 ? kLdr : kLdc, m + base,
                                 D, qt * kQB, dc * kC, N, D);
    }
    cp_async_commit();
  };
  load_tile(sK, ldk, k + base, D, k0, 0, kKB, nc * kC, N, D);
  load_tile(sV, ldk, v + base, D, k0, 0, kKB, nc * kC, N, D);
  issue(0);
  issue(1);

  float adv[kMaxChunks * 2][4], adk[kMaxChunks * 2][4];
  zero(adv);
  zero(adk);
  int j = 0;
  for (int q0 = 0; q0 < N; q0 += kQB) {
    float s[2][4], dp[2][4];
    zero(s);
    zero(dp);
    for (int dc = 0; dc < nc; ++dc, ++j) {
      ring_step(j, issue);
      float part[2][4];
      zero(part);
      prod_row(part, sK + r0 * ldk + dc * kC, ldk, slot(j), 16 * wc, g, t);
      add_to(s, part);
    }
    for (int dc = 0; dc < nc; ++dc, ++j) {
      ring_step(j, issue);
      float part[2][4];
      zero(part);
      prod_row(part, sV + r0 * ldk + dc * kC, ldk, slot(j), 16 * wc, g, t);
      add_to(dp, part);
    }
    // P^T and dS^T, 0 past N; dS^T to the scratch and both to the planes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + r0 + g + 8 * (e >> 1);
        const int qq = q0 + 16 * wc + 8 * i + 2 * t + (e & 1);
        const bool ok = key < N && qq < N;
        const float p = ok ? expf(s[i][e] * scale - lse[row0 + qq]) : 0.f;
        s[i][e] = p;
        dp[i][e] = ok ? p * (dp[i][e] - delta[row0 + qq]) : 0.f;
      }
      const int col = 16 * wc + 8 * i + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            dst_out + ((size_t)b * Np + k0 + r0 + g + 8 * h) * Np + q0 +
            col) = make_float2(dp[i][2 * h], dp[i][2 * h + 1]);
      put_planes(pHi, pLo, r0 + g, col, s[i]);
      put_planes(dHi, dLo, r0 + g, col, dp[i]);
    }
    // dV += P^T dO, then dK += dS^T Q, one D-chunk at a time
#pragma unroll
    for (int dc = 0; dc < kMaxChunks; ++dc) {
      if (dc < nc) {
        ring_step(j, issue);
        float part[2][4];
        zero(part);
        prod_pair(part, pHi + r0 * kLdp, pLo + r0 * kLdp, slot(j), 16 * wc,
                  g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) adv[2 * dc + i][e] += part[i][e];
        ++j;
      }
    }
#pragma unroll
    for (int dc = 0; dc < kMaxChunks; ++dc) {
      if (dc < nc) {
        ring_step(j, issue);
        float part[2][4];
        zero(part);
        prod_pair(part, dHi + r0 * kLdp, dLo + r0 * kLdp, slot(j), 16 * wc,
                  g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) adk[2 * dc + i][e] += part[i][e];
        ++j;
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + g + 8 * h;
    if (key >= N) continue;
#pragma unroll
    for (int dc = 0; dc < kMaxChunks; ++dc)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = dc * kC + 16 * wc + 8 * i + 2 * t;
        if (dc < nc && n < D) {
          const size_t at = base + (size_t)key * D + n;
          *reinterpret_cast<float2*>(dv + at) =
              make_float2(adv[2 * dc + i][2 * h], adv[2 * dc + i][2 * h + 1]);
          *reinterpret_cast<float2*>(dk + at) =
              make_float2(adk[2 * dc + i][2 * h] * scale,
                          adk[2 * dc + i][2 * h + 1] * scale);
        }
      }
  }
}

size_t dkdv_smem(int D) {
  return sizeof(float) * ((size_t)2 * kKB * (padded_d(D) + 8) +
                          kStages * kSlot + 4 * kKB * kLdp);
}

}  // namespace

// The arguments of uig_attention_bwd for fp32 (o is the forward's fp32
// output); only the first B Np^2 floats of ds are used (dS^T).
extern "C" cudaError_t uig_attention_bwd_dkdv(
    const float* q, const float* k, const float* v, const float* o,
    const float* lse, const float* dout, float* delta, float* ds, float* dq,
    float* dk, float* dv, int B, int N, int D, float scale,
    cudaStream_t stream) {
  const int rows = B * N, per_block = kThreads / 32;
  const int Np = (N + kScoreTile - 1) / kScoreTile * kScoreTile;
  attn_delta_kernel<float><<<(rows + per_block - 1) / per_block, kThreads, 0,
                             stream>>>(o, dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = dkdv_smem(D);
  err = cudaFuncSetAttribute(attn_dkdv_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attn_dkdv_tc_kernel<<<dim3((N + kKB - 1) / kKB, B), kThreads, smem,
                        stream>>>(q, k, v, dout, lse, delta, ds, dk, dv, N, D,
                                  Np, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_gemm(attn_dq_tc_kernel<float>, gemm_smem<float>(),
                     dim3((D + kGN - 1) / kGN, (N + kGR - 1) / kGR, B), k, ds,
                     dq, N, D, Np, scale, stream);
}
