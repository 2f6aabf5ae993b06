// Instance norm backward over NHWC fp32 or bf16, with the optional fused
// ReLU:
// given x, gamma, beta and dy, write
//   dx = r * (gamma * dy' - mean(gamma * dy') - xhat * mean(gamma * dy' * xhat))
//   dgamma = sum over (b, h, w) of dy' * xhat,  dbeta = sum of dy'
// where xhat = (x - mean) * r and dy' is dy masked by xhat * gamma + beta > 0
// when relu (the mask comes from the recomputed pre-activation).
//
// Replaces: src/uig/kernels/norm_pallas.py, _bwd_impl -> _in_bwd_kernel (the
// TPU kernel keeps one example's plane and its gradient in VMEM and
// accumulates dgamma/dbeta across the sequential batch grid). In bf16, x, dy
// and dx are bf16 and every statistic, sum, dgamma and dbeta fp32, as there.
//
// Bound on this card: bytes. It must read x and dy once and write dx once:
// at (16, 256, 256, 64) fp32 that is 3 x 268 MB, ~0.24 ms at the H100 SXM
// data-sheet 3.35 TB/s (700 W), half that in bf16; a few operations per
// byte.
//
// Design: a plane does not fit a block, and blocks run in no order, so the
// batch-sequential accumulation becomes fixed-order passes with no atomics:
//   1. in_partials_kernel (in_common.cuh): per-chunk sums of x and x^2;
//   2. one thread per (b, c) reduces them in chunk order into mean and
//      1/sqrt(var + eps), with the forward's formulas;
//   3. per-chunk sums of dy' and dy' * xhat (same block shape as 1);
//   4. one thread per (b, c) reduces those in chunk order;
//   5. one thread per c sums the per-example results over b in order into
//      dgamma and dbeta;
//   6. a 4-wide elementwise pass writes dx, rounded once to its type.
// x is read three times and dy twice; the repeats partly hit the 50 MB L2.
// Repeat runs give the same bits.
#include <cuda_runtime.h>

#include "in_common.cuh"

namespace {

// ws planes, each (B, C): mean, rstd, k1 = gamma * mean(dy'),
// k2 = gamma * mean(dy' * xhat), A = sum(dy'), Bs = sum(dy' * xhat).
enum { kMean = 0, kRstd, kK1, kK2, kA, kBs, kPlanes };

__global__ void in_bwd_stats_kernel(const float* __restrict__ part,
                                    float* __restrict__ ws, int B, int C,
                                    int chunks, float n, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C;
  const int c = i - b * C;
  const size_t plane = (size_t)B * chunks * C;
  const float* p1 = part + (size_t)b * chunks * C + c;
  const float* p2 = p1 + plane;
  float s1 = 0.f, s2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    s1 += p1[(size_t)k * C];
    s2 += p2[(size_t)k * C];
  }
  const float m = s1 / n;
  const float var = fmaxf(s2 / n - m * m, 0.f);
  ws[(size_t)kMean * B * C + i] = m;
  ws[(size_t)kRstd * B * C + i] = 1.f / sqrtf(var + eps);
}

__device__ __forceinline__ float masked_dy(float dy, float xh, float g,
                                           float be, int relu) {
  return (relu && !(xh * g + be > 0.f)) ? 0.f : dy;
}

// grid (chunks, ceil(C / kCT), B), block (kCT, kRows): per-chunk sums of dy'
// and dy' * xhat into part (2, B, chunks, C).
template <typename T>
__global__ void __launch_bounds__(kCT * kRows)
    in_bwd_partials_kernel(const T* __restrict__ x,
                           const T* __restrict__ dy,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const float* __restrict__ ws,
                           float* __restrict__ part, int B, int HW, int C,
                           int chunks, int rows_per_chunk, int relu) {
  const int c = blockIdx.y * kCT + threadIdx.x;
  const int b = blockIdx.z;
  const int chunk = blockIdx.x;
  const int p0 = chunk * rows_per_chunk;
  const int p1 = min(p0 + rows_per_chunk, HW);
  float sa = 0.f, sb = 0.f;
  if (c < C) {
    const size_t bc = (size_t)b * C + c;
    const float m = ws[(size_t)kMean * B * C + bc];
    const float r = ws[(size_t)kRstd * B * C + bc];
    const float g = gamma[c], be = beta[c];
    const size_t base = (size_t)b * HW * C + c;
    for (int p = p0 + threadIdx.y; p < p1; p += kRows) {
      const size_t o = base + (size_t)p * C;
      const float xh = (to_f32(x[o]) - m) * r;
      const float d = masked_dy(to_f32(dy[o]), xh, g, be, relu);
      sa += d;
      sb += d * xh;
    }
  }
  __shared__ float r1[kRows][kCT + 1];
  __shared__ float r2[kRows][kCT + 1];
  r1[threadIdx.y][threadIdx.x] = sa;
  r2[threadIdx.y][threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      t1 += r1[j][threadIdx.x];
      t2 += r2[j][threadIdx.x];
    }
    const size_t o = ((size_t)b * chunks + chunk) * C + c;
    part[o] = t1;
    part[(size_t)B * chunks * C + o] = t2;
  }
}

__global__ void in_bwd_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ gamma,
                                     float* __restrict__ ws, int B, int C,
                                     int chunks, float n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C;
  const int c = i - b * C;
  const size_t plane = (size_t)B * chunks * C;
  const float* p1 = part + (size_t)b * chunks * C + c;
  const float* p2 = p1 + plane;
  float sa = 0.f, sb = 0.f;
  for (int k = 0; k < chunks; ++k) {
    sa += p1[(size_t)k * C];
    sb += p2[(size_t)k * C];
  }
  const size_t bc = (size_t)B * C;
  ws[kK1 * bc + i] = gamma[c] * (sa / n);
  ws[kK2 * bc + i] = gamma[c] * (sb / n);
  ws[kA * bc + i] = sa;
  ws[kBs * bc + i] = sb;
}

__global__ void in_bwd_params_kernel(const float* __restrict__ ws,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t bc = (size_t)B * C;
  float sa = 0.f, sb = 0.f;
  for (int b = 0; b < B; ++b) {
    sa += ws[kA * bc + (size_t)b * C + c];
    sb += ws[kBs * bc + (size_t)b * C + c];
  }
  dgamma[c] = sb;
  dbeta[c] = sa;
}

// grid (x: blocks over one image's H*W*C/4 groups, y: b).
template <typename T>
__global__ void in_bwd_apply_kernel(const T* __restrict__ x,
                                    const T* __restrict__ dy,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    const float* __restrict__ ws,
                                    T* __restrict__ dx, int B, int hwc4,
                                    int C, int relu) {
  const int b = blockIdx.y;
  const int c4n = C >> 2;
  const size_t bc = (size_t)B * C;
  const float* mean = ws + kMean * bc + (size_t)b * C;
  const float* rstd = ws + kRstd * bc + (size_t)b * C;
  const float* k1 = ws + kK1 * bc + (size_t)b * C;
  const float* k2 = ws + kK2 * bc + (size_t)b * C;
  const T* xb = x + (size_t)b * hwc4 * 4;
  const T* db = dy + (size_t)b * hwc4 * 4;
  T* ob = dx + (size_t)b * hwc4 * 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < hwc4;
       i += gridDim.x * blockDim.x) {
    const int c = (i % c4n) * 4;
    const float4 xv = load4(xb + (size_t)i * 4);
    const float4 dv = load4(db + (size_t)i * 4);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
    float out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = c + q;
      const float r = rstd[cc];
      const float xh = (xs[q] - mean[cc]) * r;
      const float g = gamma[cc];
      const float d = masked_dy(ds[q], xh, g, beta[cc], relu);
      out[q] = r * (g * d - k1[cc] - xh * k2[cc]);
    }
    store4(ob + (size_t)i * 4, make_float4(out[0], out[1], out[2], out[3]));
  }
}

template <typename T>
cudaError_t bwd(const T* x, const float* gamma, const float* beta, const T* dy,
                T* dx, float* dgamma, float* dbeta, float* part, float* ws,
                int B, int HW, int C, int chunks, int rows_per_chunk,
                float eps, int relu, cudaStream_t stream) {
  const dim3 grid(chunks, (C + kCT - 1) / kCT, B);
  const dim3 block(kCT, kRows);
  const int bc = B * C;
  const float n = (float)HW;
  in_partials_kernel<T><<<grid, block, 0, stream>>>(x, part, B, HW, C, chunks,
                                                    rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_stats_kernel<<<(bc + 255) / 256, 256, 0, stream>>>(part, ws, B, C,
                                                            chunks, n, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  in_bwd_partials_kernel<T><<<grid, block, 0, stream>>>(
      x, dy, gamma, beta, ws, part, B, HW, C, chunks, rows_per_chunk, relu);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  in_bwd_reduce_kernel<<<(bc + 255) / 256, 256, 0, stream>>>(part, gamma, ws,
                                                             B, C, chunks, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  in_bwd_params_kernel<<<(C + 255) / 256, 256, 0, stream>>>(ws, dgamma, dbeta,
                                                            B, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int hwc4 = HW * (C / 4);
  int gx = (hwc4 + 255) / 256;
  if (gx > 1024) gx = 1024;
  in_bwd_apply_kernel<T><<<dim3(gx, B), 256, 0, stream>>>(
      x, dy, gamma, beta, ws, dx, B, hwc4, C, relu);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (B, HW, C) fp32, or bf16 when is_bf16; C % 4 == 0. gamma,
// beta, dgamma, dbeta: (C,) fp32. part: (2, B, chunks, C) fp32 scratch;
// ws: (6, B, C) fp32 scratch. chunks * rows_per_chunk >= HW.
extern "C" cudaError_t uig_instance_norm_bwd(
    const void* x, const float* gamma, const float* beta, const void* dy,
    void* dx, float* dgamma, float* dbeta, float* part, float* ws, int B,
    int HW, int C, int chunks, int rows_per_chunk, float eps, int relu,
    int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return bwd<bf16>(static_cast<const bf16*>(x), gamma, beta,
                     static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
                     dgamma, dbeta, part, ws, B, HW, C, chunks,
                     rows_per_chunk, eps, relu, stream);
  return bwd<float>(static_cast<const float*>(x), gamma, beta,
                    static_cast<const float*>(dy), static_cast<float*>(dx),
                    dgamma, dbeta, part, ws, B, HW, C, chunks, rows_per_chunk,
                    eps, relu, stream);
}
