// Instance norm backward over NHWC fp32 or bf16, with the optional fused
// ReLU, from the forward's statistics: given x, gamma, beta, dy and the
// mean and r = 1/sqrt(var + eps) per (b, c) that the forward's finalize kept
// (in_common.cuh), write
//   dx = r * (gamma * dy' - mean(gamma * dy') - xhat * mean(gamma * dy' * xhat))
//   dgamma = sum over (b, h, w) of dy' * xhat,  dbeta = sum of dy'
// where xhat = (x - mean) * r and dy' is dy masked by xhat * gamma + beta > 0
// when relu.
//
// Replaces: src/uig/kernels/norm_pallas.py, _bwd_impl -> _in_bwd_kernel (the
// TPU kernel keeps one example's plane and its gradient in VMEM, recomputes
// the statistics there, and accumulates dgamma/dbeta across the sequential
// batch grid). The statistics come from the forward instead, as the JAX
// convin VJP carries its forward's mean and rstd into its backward
// (convin_pallas.py). In bf16, x, dy and dx are bf16 and every statistic,
// sum, dgamma and dbeta fp32, as there.
//
// Bound on this card: bytes. It must read x and dy once and write dx once:
// at (16, 256, 256, 64) fp32 that is 3 x 268 MB, ~0.24 ms at the H100 SXM
// data-sheet 3.35 TB/s (700 W), half that in bf16; a few operations per
// byte.
//
// Design: a plane does not fit a block, and blocks run in no order, so the
// batch-sequential accumulation becomes two passes over one grid of blocks
// (pixel chunk, channel group, b), 256 threads each as qb channel pieces x
// 256 / qb pixel lanes. Where C % 4 == 0 a piece is 4 channels (qb =
// min(C / 4, 32): a warp reads whole 512-byte pixel rows at C >= 128), one
// 16-byte load of x and one of dy (8-byte in bf16); any other C takes
// pieces of one channel (qb = min(C, 128)). No float atomics:
//   1. in_bwd_sums_kernel: per-chunk sums of dy' and dy' * xhat, the pixel
//      lanes added in order through shared memory, into part (2, B, chunks,
//      C); it also zeroes the tickets of pass 2.
//   2. in_bwd_dx_kernel: each block first reduces the chunk partials of its
//      own (b, channels) in chunk order (every block of an image reads the
//      same partials in the same order, so all get the same values), then
//      writes dx for its chunk, rounded once to its type. The block of
//      chunk 0 of each (b, group) also writes its (b, c) sums to ws and
//      takes an integer ticket; the last of a channel group's B tickets
//      sums them over b in order into dgamma and dbeta.
// Pass 2 takes the blocks in the reverse order of pass 1, so that the
// images pass 1 read last are still in the 50 MB L2 when pass 2 reads them
// again: at the trunk's (8, 64, 64, 256) x and dy are 32 MB each in fp32.
// Repeat runs give the same bits.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kBwdThreads = 256;

__device__ __forceinline__ float masked_dy(float dy, float xh, float g,
                                           float be, int relu) {
  return (relu && !(xh * g + be > 0.f)) ? 0.f : dy;
}

__device__ __forceinline__ void to_array(float4 v, float (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// W channels from p: one 16-byte load of fp32 (8-byte of bf16) where W ==
// 4, one element where W == 1; and their store, rounded once to T.
template <int W>
__device__ __forceinline__ void load_w(const float* p, float (&a)[W]) {
  if constexpr (W == 4)
    to_array(*reinterpret_cast<const float4*>(p), a);
  else
    a[0] = *p;
}
template <int W, typename T>
__device__ __forceinline__ void load_t(const T* p, float (&a)[W]) {
  if constexpr (W == 4)
    to_array(load4(p), a);
  else
    a[0] = to_f32(*p);
}
template <int W, typename T>
__device__ __forceinline__ void store_t(T* p, const float (&a)[W]) {
  if constexpr (W == 4)
    store4(p, make_float4(a[0], a[1], a[2], a[3]));
  else
    *p = from_f32<T>(a[0]);
}

// The thread's place: pixel lane `lane` of `lanes`, channels c .. c + W - 1.
struct Place {
  int lane, lanes, c;
  bool ok;
};

template <int W>
__device__ __forceinline__ Place place(int qb, int group, int C) {
  Place p;
  p.lanes = kBwdThreads / qb;
  p.lane = threadIdx.x / qb;
  p.c = (group * qb + threadIdx.x % qb) * W;
  p.ok = p.lane < p.lanes && p.c < C;
  return p;
}

// grid (chunks, groups, B), block kBwdThreads. stats: (2, B, C), mean and
// r; part: (2, B, chunks, C), sums of dy' and dy' * xhat.
template <typename T, int W>
__global__ void __launch_bounds__(kBwdThreads)
    in_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ stats,
                       float* __restrict__ part, int* __restrict__ tickets,
                       int B, int HW, int C, int rows_per_chunk, int qb,
                       int relu) {
  const int b = blockIdx.z, chunk = blockIdx.x, chunks = gridDim.x;
  const Place pl = place<W>(qb, blockIdx.y, C);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = threadIdx.x; i < gridDim.y; i += kBwdThreads) tickets[i] = 0;
  float sa[W], sb[W];
#pragma unroll
  for (int e = 0; e < W; ++e) sa[e] = sb[e] = 0.f;
  if (pl.ok) {
    const size_t bc = (size_t)b * C + pl.c;
    float m[W], r[W], g[W], be[W];
    load_w<W>(stats + bc, m);
    load_w<W>(stats + (size_t)B * C + bc, r);
    load_w<W>(gamma + pl.c, g);
    load_w<W>(beta + pl.c, be);
    const int p0 = chunk * rows_per_chunk;
    const int p1 = min(p0 + rows_per_chunk, HW);
    const size_t base = (size_t)b * HW * C + pl.c;
#pragma unroll 4
    for (int p = p0 + pl.lane; p < p1; p += pl.lanes) {
      float xs[W], ds[W];
      load_t<W>(x + base + (size_t)p * C, xs);
      load_t<W>(dy + base + (size_t)p * C, ds);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float xh = (xs[e] - m[e]) * r[e];
        const float d = masked_dy(ds[e], xh, g[e], be[e], relu);
        sa[e] += d;
        sb[e] += d * xh;
      }
    }
  }
  // red[stat][e][thread]: the lanes of a channel added in lane order
  __shared__ float red[2][W][kBwdThreads];
#pragma unroll
  for (int e = 0; e < W; ++e) {
    red[0][e][threadIdx.x] = sa[e];
    red[1][e][threadIdx.x] = sb[e];
  }
  __syncthreads();
  const int cc = threadIdx.x;  // channel of the group
  const int c = blockIdx.y * qb * W + cc;
  if (cc < W * qb && c < C) {
    const int q = cc / W, e = cc % W;
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < pl.lanes; ++l) {
      t1 += red[0][e][l * qb + q];
      t2 += red[1][e][l * qb + q];
    }
    const size_t o = ((size_t)b * chunks + chunk) * C + c;
    part[o] = t1;
    part[(size_t)B * chunks * C + o] = t2;
  }
}

// The same grid, its blocks taken in reverse order. ws: (2, B, C) fp32,
// the per-(b, c) sums of dy' and dy' * xhat, for dgamma and dbeta.
template <typename T, int W>
__global__ void __launch_bounds__(kBwdThreads)
    in_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ stats,
                     const float* __restrict__ part, float* __restrict__ ws,
                     int* __restrict__ tickets, T* __restrict__ dx,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     int B, int HW, int C, int rows_per_chunk, int qb,
                     int relu) {
  const int chunks = gridDim.x;
  const int chunk = chunks - 1 - blockIdx.x;
  const int group = gridDim.y - 1 - blockIdx.y;
  const int b = B - 1 - blockIdx.z;
  const size_t plane = (size_t)B * chunks * C;
  const float n = (float)HW;
  // k[0][cc] = gamma * mean(dy'), k[1][cc] = gamma * mean(dy' * xhat)
  __shared__ float k[2][128];
  __shared__ int last;
  const int cc = threadIdx.x;
  const int c = group * qb * W + cc;
  const bool reduces = cc < W * qb && c < C;
  float sa = 0.f, sb = 0.f;
  if (reduces) {
    const float* p1 = part + (size_t)b * chunks * C + c;
    for (int j = 0; j < chunks; ++j) {
      sa += p1[(size_t)j * C];
      sb += p1[plane + (size_t)j * C];
    }
    const float g = gamma[c];
    k[0][cc] = g * (sa / n);
    k[1][cc] = g * (sb / n);
  }
  if (chunk == 0) {  // dgamma and dbeta: the last of the group's B blocks
    if (reduces) {
      ws[(size_t)b * C + c] = sa;
      ws[(size_t)(B + b) * C + c] = sb;
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&tickets[group], 1) == B - 1;
    __syncthreads();
    if (last && reduces) {
      float ta = 0.f, tb = 0.f;
      for (int i = 0; i < B; ++i) {  // images in order
        ta += __ldcg(ws + (size_t)i * C + c);
        tb += __ldcg(ws + (size_t)(B + i) * C + c);
      }
      dgamma[c] = tb;
      dbeta[c] = ta;
    }
  }
  __syncthreads();
  const Place pl = place<W>(qb, group, C);
  if (!pl.ok) return;
  const size_t bc = (size_t)b * C + pl.c;
  const int q4 = pl.c - group * qb * W;
  float m[W], r[W], g[W], be[W], k1[W], k2[W];
  load_w<W>(stats + bc, m);
  load_w<W>(stats + (size_t)B * C + bc, r);
  load_w<W>(gamma + pl.c, g);
  load_w<W>(beta + pl.c, be);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    k1[e] = k[0][q4 + e];
    k2[e] = k[1][q4 + e];
  }
  const int p0 = chunk * rows_per_chunk;
  const int p1 = min(p0 + rows_per_chunk, HW);
  const size_t base = (size_t)b * HW * C + pl.c;
#pragma unroll 4
  for (int p = p0 + pl.lane; p < p1; p += pl.lanes) {
    const size_t o = base + (size_t)p * C;
    float xs[W], ds[W], out[W];
    load_t<W>(x + o, xs);
    load_t<W>(dy + o, ds);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float xh = (xs[e] - m[e]) * r[e];
      const float d = masked_dy(ds[e], xh, g[e], be[e], relu);
      out[e] = r[e] * (g[e] * d - k1[e] - xh * k2[e]);
    }
    store_t<W>(dx + o, out);
  }
}

template <typename T, int W>
cudaError_t bwd(const T* x, const float* gamma, const float* beta, const T* dy,
                const float* stats, T* dx, float* dparams, float* scratch,
                int B, int HW, int C, int chunks, int rows_per_chunk, int qb,
                int relu, cudaStream_t stream) {
  const int groups = (C / W + qb - 1) / qb;
  const dim3 grid(chunks, groups, B);
  float* part = scratch;
  float* ws = part + 2 * (size_t)B * chunks * C;
  int* tickets = reinterpret_cast<int*>(ws + 2 * (size_t)B * C);
  float* dgamma = dparams;
  float* dbeta = dparams + C;
  in_bwd_sums_kernel<T, W><<<grid, kBwdThreads, 0, stream>>>(
      x, dy, gamma, beta, stats, part, tickets, B, HW, C, rows_per_chunk, qb,
      relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_dx_kernel<T, W><<<grid, kBwdThreads, 0, stream>>>(
      x, dy, gamma, beta, stats, part, ws, tickets, dx, dgamma, dbeta, B, HW,
      C, rows_per_chunk, qb, relu);
  return cudaGetLastError();
}

template <int W>
cudaError_t bwd_any(const void* x, const float* gamma, const float* beta,
                    const void* dy, const float* stats, void* dx,
                    float* dparams, float* scratch, int B, int HW, int C,
                    int chunks, int rows_per_chunk, int qb, int relu,
                    int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return bwd<bf16, W>(static_cast<const bf16*>(x), gamma, beta,
                        static_cast<const bf16*>(dy), stats,
                        static_cast<bf16*>(dx), dparams, scratch, B, HW, C,
                        chunks, rows_per_chunk, qb, relu, stream);
  return bwd<float, W>(static_cast<const float*>(x), gamma, beta,
                       static_cast<const float*>(dy), stats,
                       static_cast<float*>(dx), dparams, scratch, B, HW, C,
                       chunks, rows_per_chunk, qb, relu, stream);
}

}  // namespace

// x, dy, dx: (B, HW, C) fp32, or bf16 when is_bf16; any C >= 1. gamma,
// beta: (C,) fp32; dparams: (2, C) fp32, dgamma then dbeta. stats: (2, B,
// C) fp32, the forward's mean and 1/sqrt(var + eps). scratch: the partials
// (2, B, chunks, C) fp32, the per-(b, c) sums (2, B, C) fp32, then
// ceil(C / w / qb) int32 tickets. chunks * rows_per_chunk >= HW; w
// channels a piece: 4 (C % 4 == 0, 16-byte aligned operands; qb <= 32
// pieces a block) or 1 (qb <= 128).
extern "C" cudaError_t uig_instance_norm_bwd(
    const void* x, const float* gamma, const float* beta, const void* dy,
    const float* stats, void* dx, float* dparams, float* scratch, int B,
    int HW, int C, int chunks, int rows_per_chunk, int w, int qb, int relu,
    int is_bf16, cudaStream_t stream) {
  if (w == 4 && C % 4 == 0 && qb >= 1 && qb <= 32)
    return bwd_any<4>(x, gamma, beta, dy, stats, dx, dparams, scratch, B, HW,
                      C, chunks, rows_per_chunk, qb, relu, is_bf16, stream);
  if (w == 1 && qb >= 1 && qb <= 128)
    return bwd_any<1>(x, gamma, beta, dy, stats, dx, dparams, scratch, B, HW,
                      C, chunks, rows_per_chunk, qb, relu, is_bf16, stream);
  return cudaErrorInvalidValue;
}
